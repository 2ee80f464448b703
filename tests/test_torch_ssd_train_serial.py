"""The port's ssm ``train_split`` at M = 1 against the JAX package's, on
reduced mamba2-1.3b: 4 sequences of 64 tokens a step, two chunks each.
Set-up, tolerances and comparison are those of
``tests/test_torch_ssd_train.py``.
"""
from test_torch_ssd_train import (_compiled_reference,  # noqa: F401
                                  _one_torch_thread, run_against_jax, setup)


def test_train_split_ssm_serial_matches_jax(setup):  # noqa: F811
    """Three serial steps: per-step losses and the final tower and server
    params at 1e-4; the port's step 0 verified in the run."""
    run_against_jax(setup, "serial")
