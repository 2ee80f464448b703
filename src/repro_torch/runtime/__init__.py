"""Role-0 drivers: the training Executor and its step pipeline, the merge
fast path and the serving driver."""
