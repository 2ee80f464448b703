"""The port's ``train_split`` at window 2 against the JAX package: step
t+1's tower forwards run before step t's update reaches the towers
(delayed tower gradients, ``report.staleness == 1``).  Set-up,
tolerances and comparison are those of ``tests/test_torch_train_split.py``,
which holds window 1.
"""
from test_torch_train_split import (_one_torch_thread,  # noqa: F401
                                    run_against_jax, setup)


def test_train_split_window_2_matches_jax(setup):  # noqa: F811
    """Three steps at window 2: per-step losses and the final tower and
    server params at 1e-4; the port's step 0 verified in the run."""
    run_against_jax(setup, window=2)
