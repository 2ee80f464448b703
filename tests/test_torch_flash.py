"""The port's long-prompt attention against the JAX package, on the CPU.

Four groups, inputs made from numpy seeds and handed to both packages:

* the plain flash attention (``kernels/ref.flash_attention``) against the
  JAX package's oracle and its Pallas kernel in interpret mode (64-blocks),
  over the JAX test's own shape ranges: 5e-4 in f32, 3e-2 in bf16, the
  JAX package's tolerances for that kernel;
* the chunked online softmax (``models/attention.chunked_flash_attention``)
  against the JAX one, GQA with 3 q heads per kv head: 1e-5, the same
  blocked arithmetic;
* ``attention_apply`` just past the 2048**2 threshold, forward and
  gradient, with the same params;
* reduced smollm-360m split serving of one 2304-token prompt against the
  JAX ``SplitLMServer``: identical greedy tokens, prefill logits within
  1e-4, equal ledger bytes.

The kernel build (``kernels/build``) is checked here as far as a machine
without ``nvcc`` can: the library's content hash and a refused compile.
The CUDA kernel's arithmetic is modelled in numpy and held to the JAX
oracle: its 3xTF32 split (round to nearest, ties away; a_lo b_hi +
a_hi b_lo + a_hi b_hi), against which one TF32 pass errs at least 10x
more, and its shared-memory operand layout, wgmma descriptors and
fragment indexing (exact, in float64), at every head dim it takes: kv
tiles of 64 rows up to D = 64, of 32 above, where Q's lo operand is read
from shared memory through a descriptor.
"""
import os
import stat
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_pallas_flash
from repro.models import attention as jax_attn
from repro.models import backbone as jax_backbone
from repro.models import split_program as jax_split_program
from repro.serve import SplitLMServer as JaxSplitLMServer
from repro.transport import SimTransport as JaxSimTransport
from repro.transport import TowerWorker as JaxTowerWorker
from repro_torch.configs.base import get_arch
from repro_torch.core import costs
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.models import attention as attn
from repro_torch.models import split_program
from repro_torch.serve import SplitLMServer
from repro_torch.transport import SimTransport, build_split_worker
from wgmma_model import (CORE, _core_index, _fragments, _from_wgmma, _lanes,
                         _split, _tf32, _tf32_product, _wgmma, _wgmma_b)

FLASH_TOL = {"float32": 5e-4, "bfloat16": 3e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _qkv(seed, shape, kv_heads=None):
    B, H, S, D = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    kv = (B, kv_heads or H, S, D)
    return q, rng.standard_normal(kv).astype(np.float32), \
        rng.standard_normal(kv).astype(np.float32)


def _port_flash(q, k, v, causal, dtype):
    t = [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in (q, k, v)]
    return ref.flash_attention(*t, causal=causal).float().numpy()


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


# ---------------------------------------------------------------------------
# the plain flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,s,d", [(1, 2, 128, 32), (2, 3, 256, 64),
                                     (1, 2, 128, 80), (1, 2, 128, 112),
                                     (1, 2, 128, 128)])
def test_plain_flash_matches_jax_oracle_and_pallas(b, h, s, d, causal,
                                                   dtype):
    q, k, v = _qkv(s + d, (b, h, s, d))
    got = _port_flash(q, k, v, causal, dtype)
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    tol = FLASH_TOL[dtype]
    for want in (jax_ref.flash_attention(jq, jk, jv, causal=causal),
                 jax_pallas_flash(jq, jk, jv, causal=causal, block_q=64,
                                  block_kv=64, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_plain_flash_matches_pallas_hypothesis_sweep():
    """The JAX test's own ranges: b 1-2, h 1-3, s 128/256, d 32/64,
    causal or full, f32 or bf16."""
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=8, deadline=None)
    @given(b=st.integers(1, 2), h=st.integers(1, 3),
           s=st.sampled_from([128, 256]), d=st.sampled_from([32, 64]),
           causal=st.booleans(),
           dtype=st.sampled_from(["float32", "bfloat16"]),
           seed=st.integers(0, 99))
    def prop(b, h, s, d, causal, dtype, seed):
        q, k, v = _qkv(seed, (b, h, s, d))
        want = jax_pallas_flash(*(_jax(a, dtype) for a in (q, k, v)),
                                causal=causal, block_q=64, block_kv=64,
                                interpret=True)
        tol = FLASH_TOL[dtype]
        np.testing.assert_allclose(_port_flash(q, k, v, causal, dtype),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)

    prop()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("h,hkv,s", [(4, 2, 37), (6, 2, 100), (3, 1, 600),
                                     (15, 5, 65)])
def test_plain_flash_gqa_matches_jax_with_repeated_kv(h, hkv, s, causal):
    """GQA: kv head h // (H // Hkv) serves q head h — the JAX oracle with
    the kv heads repeated, as its callers do.  Ragged S included."""
    q, k, v = _qkv(h * s, (1, h, s, 64), kv_heads=hkv)
    rep = h // hkv
    want = jax_ref.flash_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=1),
        jnp.repeat(jnp.asarray(v), rep, axis=1), causal=causal)
    np.testing.assert_allclose(_port_flash(q, k, v, causal, "float32"),
                               np.asarray(want), rtol=5e-4, atol=5e-4)


def test_plain_flash_row_blocks_are_exact(monkeypatch):
    """Row blocks (FLASH_ROWS) change only how much of the score matrix is
    held at once, not the result."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, (1, 3, 300, 32)))
    whole = ref.flash_attention(q, k, v, causal=True)
    monkeypatch.setattr(ref, "FLASH_ROWS", 64)
    torch.testing.assert_close(ref.flash_attention(q, k, v, causal=True),
                               whole, rtol=0, atol=0)


def test_flash_dispatch_runs_plain_version_on_cpu():
    """ops.flash_attention on CPU tensors is the plain version, with no
    launch counted — the kernel wrapper itself refuses CPU tensors."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, (2, 4, 50, 32), 2))
    flash_kernel.reset_launches()
    got = ops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, causal=True),
                               rtol=0, atol=0)
    assert flash_kernel.launches == {"flash_attention_kernel": 0}
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_kernel.flash_attention(q, k, v, causal=True)


# ---------------------------------------------------------------------------
# the chunked online softmax and attention_apply past the threshold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,chunk", [(2304, 384), (2500, 500)])
def test_chunked_flash_matches_jax(S, chunk, causal):
    assert attn._pick_chunk(S, 512) == jax_attn._pick_chunk(S, 512) == chunk
    rng = np.random.default_rng(S)
    B, H, Kv, hd = 1, 3, 1, 8
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want = jax_attn.chunked_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
        q_chunk=chunk, kv_chunk=chunk)
    got = attn.chunked_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_positions=torch.from_numpy(pos).long(),
        kv_positions=torch.from_numpy(pos).long(), q_chunk=chunk,
        kv_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_pick_chunk_matches_jax():
    for n in (1, 7, 512, 513, 1000, 2049, 2050, 2304, 2500, 4096, 32768):
        for target in (64, 500, 512):
            assert attn._pick_chunk(n, target) == \
                jax_attn._pick_chunk(n, target), (n, target)


def _attention_case(S, seed=0):
    d_model, H, Kv, hd = 24, 3, 1, 8
    rng = np.random.default_rng(seed)
    params = {name: (rng.standard_normal(shape) * 0.2).astype(np.float32)
              for name, shape in (("wq", (d_model, H * hd)),
                                  ("wk", (d_model, Kv * hd)),
                                  ("wv", (d_model, Kv * hd)),
                                  ("wo", (H * hd, d_model)))}
    x = rng.standard_normal((1, S, d_model)).astype(np.float32)
    return params, x, dict(n_heads=H, n_kv_heads=Kv, head_dim=hd)


@pytest.mark.parametrize("S", [2048, 2050])
def test_attention_apply_past_threshold_matches_jax(S):
    """2048 takes the dense branch in both packages, 2050 the blocked one
    (chunks of 410); outputs and K/V agree."""
    params, x, kw = _attention_case(S)
    jout, (jk, jv) = jax_attn.attention_apply(
        {n: jnp.asarray(a) for n, a in params.items()}, jnp.asarray(x), **kw)
    out, (k, v) = attn.attention_apply(params_from_numpy(params, "cpu"),
                                       torch.from_numpy(x), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


def test_attention_apply_past_threshold_gradient_matches_jax():
    """On the CPU the blocked path is differentiable through autograd:
    d(sum(out * w))/dx and /dwq equal jax.grad of the same loss."""
    params, x, kw = _attention_case(2050, seed=1)
    w = np.random.default_rng(2).standard_normal((1, 2050, 24)).astype(
        np.float32)

    def jloss(p, xx):
        return jnp.sum(jax_attn.attention_apply(p, xx, **kw)[0] * w)

    jp = {n: jnp.asarray(a) for n, a in params.items()}
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {n: t.requires_grad_(True)
          for n, t in params_from_numpy(params, "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(attn.attention_apply(tp, tx, **kw)[0]
                     * torch.from_numpy(w))
    gx, gwq = torch.autograd.grad(loss, (tx, tp["wq"]))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gwq.numpy(), np.asarray(jgp["wq"]), rtol=1e-4,
                               atol=1e-4)


def test_attention_apply_plain_switch_on_cpu():
    """use_kernel=False is the same chunked path on the CPU."""
    params, x, kw = _attention_case(2050, seed=3)
    tp, tx = params_from_numpy(params, "cpu"), torch.from_numpy(x)
    a, _ = attn.attention_apply(tp, tx, **kw)
    b, _ = attn.attention_apply(tp, tx, use_kernel=False, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# reduced split serving of a 2304-token prompt
# ---------------------------------------------------------------------------

LONG_PROMPT, LONG_NEW = 2304, 4
LONG_CACHE = LONG_PROMPT + LONG_NEW


@pytest.fixture(scope="module")
def long_setup():
    jcfg = jax_get_arch("smollm-360m").reduced()
    cfg = get_arch("smollm-360m").reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    prompt = np.random.default_rng(13).integers(
        0, cfg.vocab_size, LONG_PROMPT).astype(np.int32)
    return jcfg, cfg, jparams, params, prompt


def _tag_bytes(ledger):
    out = {}
    for m in ledger.messages:
        out[m.tag] = out.get(m.tag, 0) + m.num_bytes
    return out


def test_long_prompt_split_serving_matches_jax(long_setup):
    jcfg, cfg, jparams, params, prompt = long_setup
    program = jax_split_program.get_program(jcfg)
    towers, jserver = program.partition(jparams)
    jworkers = [JaxTowerWorker(k, program.tower_fwd(k), towers[k],
                               serve_fns=program.tower_serve_fns(k))
                for k in range(jcfg.vertical.num_clients)]
    jsrv = JaxSplitLMServer(JaxSimTransport(jworkers), jcfg, jserver,
                            cache_len=LONG_CACHE)
    _, server = split_program.get_program(cfg).partition(params)
    workers = [build_split_worker(k, cfg=cfg, params=params, device="cpu")
               for k in range(cfg.vertical.num_clients)]
    srv = SplitLMServer(SimTransport(workers), cfg, server,
                        cache_len=LONG_CACHE, device="cpu")

    # the prefill round, the merge and the server prefill: logits
    jcut = jsrv.driver.prefill(0, prompt, LONG_CACHE)
    jlogits, _ = jsrv._server_prefill(jsrv.server_params, jsrv._fresh_slot,
                                      jcut)
    cut = srv.driver.prefill(0, torch.from_numpy(prompt).long(), LONG_CACHE)
    logits, _ = srv._fns.prefill(srv.server_params,
                                 srv._fns.init_cache(LONG_CACHE), cut)
    np.testing.assert_allclose(to_numpy(cut), np.asarray(jcut), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)

    # served end to end: greedy tokens and every audited byte
    jsrv.submit(prompt, max_new_tokens=LONG_NEW)
    srv.submit(prompt, max_new_tokens=LONG_NEW)
    jtokens = [r.tokens for r in jsrv.run()]
    tokens = [r.tokens for r in srv.run()]
    assert tokens == jtokens and len(tokens[0]) == LONG_NEW
    port_bytes = _tag_bytes(srv.ledger)
    jax_bytes = _tag_bytes(jsrv.ledger)
    assert port_bytes == jax_bytes
    K = cfg.vertical.num_clients
    pf = costs.serve_prefill_bytes(LONG_PROMPT, cfg.d_model, K)
    dc = costs.serve_decode_bytes(cfg.d_model, K, rounds=LONG_NEW - 1)
    # two prefill rounds in each ledger: the logits check, then the run
    assert srv.wire_report()["total"] == 2 * pf["total"] + dc["total"]
    for k in range(K):
        assert port_bytes[f"serve_prefill_cut[{k}]"] == \
            2 * pf["cut_bytes_per_client"]


# ---------------------------------------------------------------------------
# the kernel build, as far as a machine without nvcc can check it
# ---------------------------------------------------------------------------

def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in build.sources():
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build.library_path()
    assert first == build.library_path()
    assert first.parent == build.BUILD_DIR
    assert first.name.startswith("libreprokernels-") and first.suffix == ".so"
    src = csrc / "flash_attention.cu"
    src.write_text(src.read_text() + "\n// an edit\n")
    assert build.library_path() != first


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "TOOLKIT_PREFIX", tmp_path / "no-toolkit")
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        build.find_nvcc()


def test_build_compiles_for_sm90a_and_reports_failure(monkeypatch, tmp_path):
    """A stand-in nvcc that records its arguments and fails: the build
    runs one compile per source with the sm_90a flags and raises with
    the compiler's output."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "args"
    nvcc = bindir / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\n"
                    "echo 'error: refused' >&2\nexit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        build.build()
    assert "error: refused" in str(err.value)
    # the compiles run in parallel: one line each, in no fixed order
    compiled = []
    for line in log.read_text().splitlines():
        args = line.split()
        assert "arch=compute_90a,code=sm_90a" in args and "-c" in args
        compiled.append(Path(args[args.index("-c") + 1]).name)
    assert "flash_attention.cu" in compiled
    assert sorted(compiled) == sorted(
        p.name for p in build.sources() if p.suffix == ".cu")
    assert not build.library_path().exists()


# ---------------------------------------------------------------------------
# the CUDA kernel's arithmetic and fragment layout, modelled in numpy
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
KERNEL_TILE = 64  # q rows per warpgroup (wgmma's M)


def _kv_tile(d):
    """kv rows per staged tile: ``Smem<T, D>::KV`` of the kernel."""
    return 32 if d > 64 else 64


def _kernel_model(q, k, v, causal, passes=3):
    """The kernel's arithmetic: 64-row q blocks (a warpgroup's), kv tiles
    of :func:`_kv_tile` rows (only up to the block's last row when
    causal), scores times log2(e)/sqrt(D), masked at -1e30, an online
    softmax in base 2, both products through :func:`_tf32_product`,
    output acc / max(l, 1e-30)."""
    B, H, S, D = q.shape
    group = H // k.shape[1]
    kv_tile = _kv_tile(D)
    scale = np.float32(LOG2E / np.sqrt(D))
    out = np.empty_like(q)
    for b in range(B):
        for h in range(H):
            kh, vh = k[b, h // group], v[b, h // group]
            for q0 in range(0, S, KERNEL_TILE):
                qb = q[b, h, q0:q0 + KERNEL_TILE]
                rows = np.arange(q0, q0 + len(qb))
                m = np.full(len(qb), -1e30, np.float32)
                lsum = np.zeros(len(qb), np.float32)
                acc = np.zeros((len(qb), D), np.float32)
                n_kv = -(-(q0 + len(qb) if causal else S) // kv_tile)
                for kv0 in range(0, n_kv * kv_tile, kv_tile):
                    kb = kh[kv0:kv0 + kv_tile]
                    vb = vh[kv0:kv0 + kv_tile]
                    s = _tf32_product(qb, kb.T, passes) * scale
                    if causal:
                        cols = np.arange(kv0, kv0 + len(kb))
                        s[cols[None, :] > rows[:, None]] = np.float32(-1e30)
                    m_new = np.maximum(m, s.max(axis=1))
                    alpha = np.exp2(m - m_new)
                    p = np.exp2(s - m_new[:, None])
                    lsum = lsum * alpha + p.sum(axis=1)
                    acc = acc * alpha[:, None] + _tf32_product(p, vb, passes)
                    m = m_new
                out[b, h, q0:q0 + len(qb)] = acc / np.maximum(
                    lsum, np.float32(1e-30))[:, None]
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv,s,d", [(6, 2, 150, 64), (3, 1, 97, 32),
                                       (2, 1, 83, 128), (2, 2, 45, 80),
                                       (1, 1, 70, 112)])
def test_3xtf32_kernel_model_matches_jax_oracle(h, hkv, s, d, causal):
    """The kernel's 3xTF32 arithmetic (round-to-nearest-away TF32, the
    hi/lo split, the three products in the kernel's order) on a GQA
    attention with a ragged last tile is held to the JAX oracle at 5e-4,
    the f32 gate.  On the same inputs a single TF32 pass errs at least 10x
    more: the split is what keeps f32 accuracy on the tensor cores."""
    q, k, v = _qkv(s * d + h, (1, h, s, d), kv_heads=hkv)
    rep = h // hkv
    want = np.asarray(jax_ref.flash_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=1),
        jnp.repeat(jnp.asarray(v), rep, axis=1), causal=causal))
    err3 = np.abs(_kernel_model(q, k, v, causal, passes=3) - want).max()
    err1 = np.abs(_kernel_model(q, k, v, causal, passes=1) - want).max()
    assert err3 <= 5e-4
    assert err1 >= 10 * err3, (err1, err3)


def test_tf32_rounding_is_to_nearest_ties_away():
    """10 mantissa bits kept; a tie (exactly half of the last kept bit)
    rounds away from zero in both signs; the split recovers x to ~22
    bits."""
    ulp = 2.0 ** -10
    x = np.array([1.0, 1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4,
                  1.0 + 3 * ulp / 4, 3.0e-3], np.float32)
    got = _tf32(x)
    np.testing.assert_array_equal(
        got[:5], np.array([1.0, 1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp],
                          np.float32))
    assert got.view(np.uint32)[5] & 0x1FFF == 0
    rng = np.random.default_rng(0)
    y = rng.standard_normal(4096).astype(np.float32)
    hi, lo = _split(y)
    assert np.abs(hi - y).max() > 1e-5  # one TF32 value is ~3 digits
    np.testing.assert_allclose(hi.astype(np.float64) + lo, y, rtol=2.0 ** -21,
                               atol=0)


@pytest.mark.parametrize("d", [32, 64, 80, 112, 128])
def test_kernel_operand_layout_and_fragments_compute_both_products(d):
    """One warpgroup's 64 q rows through the kernel's own indexing (exact,
    in float64), with the kv tile of its head dim (64 rows up to D = 64,
    32 above): the split pass writes K (thread idx: core matrix idx // 8,
    row idx % 8, at word 4 idx) and V^T (thread idx: d = idx % D, kv
    positions 4 kb .. 4 kb + 3 = kv 8j + 2e + half for kb = 2j + half);
    wgmma reads them through descriptors (K at word kk * 2 * CORE with SBO
    (D / 4) * 128 bytes, V^T at j * 2 * CORE with SBO (KV / 4) * 128
    bytes); Q's A fragments give Q K^T, and the QK^T accumulator reused as
    P V's A operand with its kv columns renamed (c0, c2, c1, c3) gives
    P V.  Above D = 64 Q's lo operand is not a fragment: each lane stores
    its four values of k-step kk at core_index(row, column, D) of the
    warpgroup's Q tile, and wgmma reads that tile as A through a
    descriptor laid out as K's (word kk * 2 * CORE, SBO (D / 4) * 128
    bytes); the model checks that this A gives the same Q K^T."""
    kv_tile = _kv_tile(d)
    rng = np.random.default_rng(d)
    Q, K, V = (rng.standard_normal(shape) for shape in
               ((64, d), (kv_tile, d), (kv_tile, d)))
    g, t = _lanes()
    k_tile = np.zeros(kv_tile * d)
    for idx in range(kv_tile * d // 4):
        kb = (idx // 8) % (d // 4)
        kv = 8 * ((idx // 8) // (d // 4)) + idx % 8
        k_tile[4 * idx:4 * idx + 4] = K[kv, 4 * kb:4 * kb + 4]
    v_tile = np.zeros(kv_tile * d)
    for idx in range(kv_tile * d // 4):
        dd, kb = idx % d, idx // d
        at = _core_index(dd, 4 * kb, kv_tile)
        kv = 8 * (kb // 2) + kb % 2 + 2 * np.arange(4)
        v_tile[at:at + 4] = V[kv, dd]
    for kv in range(kv_tile):
        for dd in range(d):
            assert k_tile[_core_index(kv, dd, d)] == K[kv, dd]

    q_frag = [_fragments(Q[:, 8 * kk:8 * kk + 8]) for kk in range(d // 8)]
    # Q's tile in shared memory, stored from each lane's fragment values
    # (value i of lane 4g + t in warp w: row 16w + g + 8 (i & 1), column
    # 8 kk + t + 4 (i >> 1)), then read back as A through a descriptor
    q_tile = np.full(64 * d, np.nan)
    for kk in range(d // 8):
        for w in range(4):
            for i in range(4):
                rows = 16 * w + g + 8 * (i & 1)
                cols = 8 * kk + t + 4 * (i >> 1)
                q_tile[_core_index(rows, cols, d)] = q_frag[kk][w, :, i]
    assert not np.isnan(q_tile).any()
    q_frag_smem = [_fragments(_wgmma_b(q_tile, kk * 2 * CORE,
                                       (d // 4) * 128, 64).T)
                   for kk in range(d // 8)]
    for frags in (q_frag, q_frag_smem):
        s = np.zeros((4, 32, kv_tile // 2))
        for kk in range(d // 8):
            s = _wgmma(frags[kk], _wgmma_b(k_tile, kk * 2 * CORE,
                                           (d // 4) * 128, kv_tile), s)
        np.testing.assert_allclose(_from_wgmma(s), Q @ K.T, rtol=1e-12,
                                   atol=1e-12)
    acc = np.zeros((4, 32, d // 2))
    for j in range(kv_tile // 8):
        pa = s[:, :, [4 * j, 4 * j + 2, 4 * j + 1, 4 * j + 3]]
        acc = _wgmma(pa, _wgmma_b(v_tile, j * 2 * CORE,
                                  (kv_tile // 4) * 128, d), acc)
    np.testing.assert_allclose(_from_wgmma(acc), (Q @ K.T) @ V, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("d", [32, 64])
def test_kernel_split_pass_reads_avoid_bank_conflicts(d):
    """f32 raw tiles, each row padded by 16 bytes (D + 4 floats).  The
    split pass reads K 16 bytes a lane, a quarter-warp (8 lanes) at a
    time: lane idx reads kv row 8 nb + idx % 8 at column 4 kb, and the 8
    lanes of each quarter touch 8 distinct groups of 4 banks.  It reads V
    4 bytes a lane: 32 neighbouring d of one kv row, 32 distinct banks.
    Unpadded rows (D floats) would put the 8 K rows on the same banks."""
    def quarters_conflict_free(first):
        for quarter in range(4):
            banks = (first[8 * quarter:8 * quarter + 8, None]
                     + np.arange(4)) % 32
            if len(set(banks.ravel())) != 32:
                return False
        return True

    for ld, padded in ((d + 4, True), (d, False)):
        ok = True
        for base in range(0, KERNEL_TILE * d // 4, 32):
            idx = base + np.arange(32)
            kb = (idx // 8) % (d // 4)
            kv = 8 * ((idx // 8) // (d // 4)) + idx % 8
            ok &= quarters_conflict_free(kv * ld + 4 * kb)
            dd, kb = idx % d, idx // d
            words = (8 * (kb // 2) + kb % 2) * ld + dd
            ok &= len(set(words % 32)) == 32
        assert ok == padded
