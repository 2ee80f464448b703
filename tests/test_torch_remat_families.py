"""Activation rematerialization on the moe, audio and vlm families:
reduced deepseek-moe-16b centralized at 3 layers (its first, dense,
layer a unit of the dense stack; each MoE layer a unit with the aux loss
carried inside it), whisper-tiny
(encoder towers and layers; each decoder layer a unit that computes its
cross K/V from the encoder output inside it) and internvl2-26b (vision
tower, text tower, server).  The checks and tolerances are
``tests/test_torch_remat.py``'s: ``remat`` True and ``"dots"`` equal to
the port's ``remat=False`` bit for bit, and within 1e-5 of the JAX
package's ``jax.grad`` of ``forward(remat=...)``, and one checkpoint
per reference scan body.
"""
import pytest

from test_torch_remat import (REMATS, _one_torch_thread,  # noqa: F401
                              check_against_jax, check_bit_equal,
                              check_units, configs, make_setup)

# family -> (arch, vertical, {field: value} replaced in both configs); the
# moe's dense layer is a tower layer when split, so it runs centralized
ARCHS = {"moe": ("deepseek-moe-16b", False, {"num_layers": 3}),
         "audio": ("whisper-tiny", True, {}),
         "vlm": ("internvl2-26b", True, {})}


@pytest.fixture(scope="module", params=list(ARCHS))
def family(request):
    arch, vertical, cut = ARCHS[request.param]
    setup = make_setup(*configs(arch, vertical, **cut))
    if request.param == "moe":
        assert "server_dense" in setup["params"]
    return setup


@pytest.mark.parametrize("remat", REMATS, ids=["full", "dots"])
def test_remat_equals_no_remat_bit_for_bit(family, remat):
    check_bit_equal(family, remat)


@pytest.mark.parametrize("remat", REMATS, ids=["full", "dots"])
def test_remat_matches_jax(family, remat):
    check_against_jax(family, remat)


def test_units_are_the_reference_scan_bodies(family):
    check_units(family)
