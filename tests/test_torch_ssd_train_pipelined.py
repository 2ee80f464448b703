"""The port's ssm ``train_split`` pipelined at M = 4 against the JAX
package's, on reduced mamba2-1.3b: each step's batch of 4 sequences of 64
tokens in four microbatches of one.  Set-up, tolerances and comparison are
those of ``tests/test_torch_ssd_train.py``;
``tests/test_torch_ssd_train_serial.py`` holds the serial run.
"""
from test_torch_ssd_train import (_compiled_reference,  # noqa: F401
                                  _one_torch_thread, run_against_jax, setup)


def test_train_split_ssm_pipelined_matches_jax(setup):  # noqa: F811
    """Three pipelined steps at M = 4: per-step losses and the final tower
    and server params at 1e-4; the port's step 0 verified in the run."""
    run_against_jax(setup, "pipelined", microbatches=4)
