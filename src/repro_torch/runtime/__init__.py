"""Role-0 drivers: the merge fast path and the serving driver."""
