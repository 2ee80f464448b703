"""Launchers: the training driver (``python -m repro_torch.launch.train``)."""
