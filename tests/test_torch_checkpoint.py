"""The port's msgpack checkpoints against the JAX package's
``repro.checkpoint.msgpack_ckpt``: the same bytes on disk for the same
tree, files loading both ways, a model's params round-tripping, and the
port's own msgpack encoder and decoder against the ``msgpack`` package
(which the port does not import).
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import msgpack_ckpt as jax_ckpt
from repro.configs.base import get_arch as jax_get_arch
from repro.models import backbone as jax_backbone
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.checkpoint.msgpack_ckpt import packb, unpackb
from repro_torch.configs.base import get_arch
from repro_torch.interop import params_from_numpy
from repro_torch.models import backbone


def _trees():
    """The reference's roundtrip tree in both packages, plus the edges of
    the format: a bool array, a zero-size array, a 0-d int64."""
    mine = {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": {"c": torch.ones(4, dtype=torch.bfloat16),
              "d": torch.tensor(3, dtype=torch.int32)},
        "lst": [torch.zeros(2), torch.ones(2)],
        "tup": (torch.full((2, 2), 7.0),),
        "none": None,
        "edges": [torch.tensor([True, False]), torch.zeros(0, 3),
                  torch.tensor(-5, dtype=torch.int64)],
    }
    theirs = {
        "a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
        "b": {"c": jnp.ones((4,), jnp.bfloat16),
              "d": jnp.asarray(3, jnp.int32)},
        "lst": [jnp.zeros(2), jnp.ones(2)],
        "tup": (jnp.full((2, 2), 7.0),),
        "none": None,
        "edges": [np.array([True, False]), np.zeros((0, 3), np.float32),
                  np.asarray(-5, np.int64)],
    }
    return mine, theirs


def _values(leaf):
    """(dtype name, float32-or-own-dtype numpy values) of a tensor or an
    array (bfloat16 compared through float32)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16", leaf.float().numpy()
        leaf = leaf.numpy()
    leaf = np.asarray(leaf)
    if leaf.dtype.name == "bfloat16":
        return "bfloat16", leaf.astype(np.float32)
    return leaf.dtype.name, leaf


def _same(got, want, kind=torch.Tensor):
    """``got`` a loaded tree (leaves of type ``kind``), ``want`` a
    JAX-side tree: structure, dtypes and values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for key in want:
            _same(got[key], want[key], kind)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b, kind)
    elif want is None:
        assert got is None
    else:
        assert isinstance(got, kind)
        (gd, gv), (wd, wv) = _values(got), _values(want)
        assert gd == wd and gv.shape == wv.shape
        np.testing.assert_array_equal(gv, wv)


def test_roundtrip(tmp_path):
    """The reference's roundtrip: f32, bf16, int32, a list, a tuple and
    None come back with their dtypes and the step; the write is atomic
    (no ``.tmp`` is left)."""
    mine, theirs = _trees()
    path = str(tmp_path / "sub" / "ckpt.msgpack")
    save_checkpoint(path, mine, step=42)
    assert sorted(os.listdir(tmp_path / "sub")) == ["ckpt.msgpack"]
    loaded, step = load_checkpoint(path, device="cpu")
    assert step == 42
    _same(loaded, theirs)
    save_checkpoint(path, mine)
    assert load_checkpoint(path)[1] is None


def test_bytes_equal_jax_package(tmp_path):
    """The same tree written by both packages gives the same file, with
    and without a step."""
    mine, theirs = _trees()
    for step in (7, None, 300, 70000):
        a, b = str(tmp_path / "port"), str(tmp_path / "jax")
        save_checkpoint(a, mine, step=step)
        jax_ckpt.save_checkpoint(b, theirs, step=step)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_files_load_both_ways(tmp_path):
    """A reference file loads in the port (every leaf a tensor of its
    dtype) and a port file loads in the reference."""
    mine, theirs = _trees()
    ref_file, port_file = str(tmp_path / "ref"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(ref_file, theirs, step=3)
    loaded, step = load_checkpoint(ref_file)
    assert step == 3
    _same(loaded, theirs)
    save_checkpoint(port_file, mine, step=4)
    jloaded, jstep = jax_ckpt.load_checkpoint(port_file)
    assert jstep == 4
    _same(jloaded, theirs, np.ndarray)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_model_params_roundtrip(tmp_path, dtype):
    """Reduced smollm-360m's params (the JAX package's init carried
    across): the port's file loads in the reference equal to the tree the
    reference itself saves, and back in the port bit for bit."""
    jcfg, cfg = jax_get_arch("smollm-360m").reduced(), \
        get_arch("smollm-360m").reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(0), dtype)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    path, ref = str(tmp_path / "model"), str(tmp_path / "model_ref")
    save_checkpoint(path, params, step=1)
    jax_ckpt.save_checkpoint(ref, jparams, step=1)
    with open(path, "rb") as fa, open(ref, "rb") as fb:
        assert fa.read() == fb.read()
    loaded, step = load_checkpoint(path, device="cpu")
    assert step == 1 and set(loaded) == set(params)
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert backbone.param_count(cfg) == sum(
        t.numel() for t in jax.tree_util.tree_leaves(loaded))


def test_msgpack_codec_matches_package():
    """``packb`` writes what ``msgpack.packb(use_bin_type=True)`` writes
    at every length and integer boundary, and ``unpackb`` reads it back as
    ``msgpack.unpackb(raw=False)`` does."""
    values = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
              2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
              -2 ** 31, -2 ** 31 - 1, -2 ** 63, "", "a" * 31, "b" * 32,
              "c" * 255, "d" * 256, "e" * 65536, "ü", b"", b"x" * 255,
              b"y" * 256, b"z" * 65536, None, True, False, [],
              list(range(15)), list(range(16)), list(range(65536)), {},
              {str(i): i for i in range(15)},
              {str(i): [i, None] for i in range(16)},
              {str(i): i for i in range(65536)},
              {"tree": {"__list__": [{"__none__": True}], "__tuple__": False},
               "step": 12}]
    for value in values:
        data = packb(value)
        assert data == msgpack.packb(value, use_bin_type=True), \
            repr(value)[:40]
        assert unpackb(data) == msgpack.unpackb(
            data, raw=False, strict_map_key=False)
    for outside in (1.5, np.float32(1.0), np.int64(3)):
        with pytest.raises(TypeError):
            packb(outside)
    with pytest.raises(ValueError):
        unpackb(packb([1, 2])[:-1])
