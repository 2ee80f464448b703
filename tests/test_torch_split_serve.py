"""The port's split serving slice against the JAX package, end to end.

Reduced smollm-360m (dense, K=2 feature holders, d_model=256), the JAX
package's params carried across by ``interop``, prompts made from a seed
with numpy; both servers over their ``SimTransport``.  Greedy tokens must
be identical, prefill logits within 1e-4, and every audited byte equal to
the JAX ledger and to the port's ``costs.serve_*``.  A bf16 tree is
served too: a decode step with an idle slot runs in f32 against the bf16
weights, as JAX promotes it, and its logits match the JAX server's.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import backbone as jax_backbone
from repro.models import split_program as jax_split_program
from repro.serve import SplitLMServer as JaxSplitLMServer
from repro.transport import SimTransport as JaxSimTransport
from repro.transport import TowerWorker as JaxTowerWorker
from repro_torch.configs.base import VerticalConfig, get_arch
from repro_torch.core import compat, costs
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import backbone, split_program
from repro_torch.serve import CutCache, SamplingParams, SplitLMServer
from repro_torch.transport import SimTransport, build_split_worker

ARCH = "smollm-360m"
PROMPT_LENS = [8, 5, 12, 7]
NEW_TOKENS = [6, 9, 4, 8]
CACHE_LEN = 32
ROOT = Path(__file__).resolve().parents[1]
STAT_KEYS = ("requests", "tokens", "decode_rounds", "prefills", "reprefills",
             "peak_active")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_arch(ARCH).reduced()
    cfg = get_arch(ARCH).reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, s).astype(np.int32)
               for s in PROMPT_LENS]
    return jcfg, cfg, jparams, params, prompts


@pytest.fixture(scope="module")
def jax_workers(setup):
    """The JAX package's serving workers over the same params, shared by
    every JAX server of the module (their jitted tower functions compile
    once; sessions are keyed by request id and reset at each prefill)."""
    jcfg, _, jparams, _, _ = setup
    program = jax_split_program.get_program(jcfg)
    towers, _ = program.partition(jparams)
    return [JaxTowerWorker(k, program.tower_fwd(k), towers[k],
                           serve_fns=program.tower_serve_fns(k))
            for k in range(jcfg.vertical.num_clients)]


def _jax_server(setup, workers, **kw):
    jcfg, _, jparams, _, _ = setup
    _, server = jax_split_program.get_program(jcfg).partition(jparams)
    return JaxSplitLMServer(JaxSimTransport(workers), jcfg, server, **kw)


def _port_server(setup, **kw):
    _, cfg, _, params, _ = setup
    _, server = split_program.get_program(cfg).partition(params)
    workers = [build_split_worker(k, cfg=cfg, params=params, device="cpu")
               for k in range(cfg.vertical.num_clients)]
    return SplitLMServer(SimTransport(workers), cfg, server, device="cpu",
                         **kw)


def _serve(srv, prompts, new_tokens):
    for p, n in zip(prompts, new_tokens):
        srv.submit(p, max_new_tokens=n)
    return [r.tokens for r in srv.run()]


def _tag_bytes(ledger):
    out = {}
    for m in ledger.messages:
        out[m.tag] = out.get(m.tag, 0) + m.num_bytes
    return out


@pytest.fixture(scope="module")
def jax_runs(setup, jax_workers):
    """The JAX package's serving runs, computed once for the module."""
    prompts = setup[4]
    runs = {}
    for continuous in (True, False):
        srv = _jax_server(setup, jax_workers, cache_len=CACHE_LEN,
                          max_batch=2, continuous=continuous)
        runs[continuous] = (_serve(srv, prompts, NEW_TOKENS), dict(srv.stats),
                            _tag_bytes(srv.ledger))
    return runs


@pytest.mark.parametrize("continuous", [True, False])
def test_split_serve_matches_jax(setup, jax_runs, continuous):
    _, cfg, _, _, prompts = setup
    srv = _port_server(setup, cache_len=CACHE_LEN, max_batch=2,
                       continuous=continuous)
    tokens = _serve(srv, prompts, NEW_TOKENS)
    jtokens, jstats, jbytes = jax_runs[continuous]
    assert tokens == jtokens
    assert {k: srv.stats[k] for k in STAT_KEYS} == \
        {k: jstats[k] for k in STAT_KEYS}
    if continuous:
        assert srv.stats["peak_active"] == 2  # a mid-flight admit happened
    # every audited byte: equal to the JAX ledger, tag by tag ...
    assert _tag_bytes(srv.ledger) == jbytes
    # ... and to the port's closed-form byte models
    K = cfg.vertical.num_clients
    rounds = srv.stats["tokens"] - srv.stats["requests"]
    assert rounds == sum(n - 1 for n in NEW_TOKENS)
    pf = costs.serve_prefill_bytes(sum(PROMPT_LENS), cfg.d_model, K)
    dc = costs.serve_decode_bytes(cfg.d_model, K, rounds=rounds)
    led = srv.ledger
    assert led.sent_by("role0") == pf["role0_sent"] + dc["role0_sent"]
    assert led.received_by("role0") == (pf["role0_received"]
                                        + dc["role0_received"])
    for k in range(K):
        assert led.bytes_with_tag(f"serve_prompt[{k}]") == \
            pf["prompt_bytes_per_client"]
        assert led.bytes_with_tag(f"serve_prefill_cut[{k}]") == \
            pf["cut_bytes_per_client"]
        assert led.bytes_with_tag(f"serve_token[{k}]") == \
            dc["token_bytes_per_client"]
        assert led.bytes_with_tag(f"serve_cut[{k}]") == \
            dc["cut_bytes_per_client"]
    assert srv.wire_report()["total"] == pf["total"] + dc["total"]


# bf16 logits of the reduced model (|logit| < 2): the repo's bf16 tolerance
# for attention, a few bf16 ulps after the stacked bf16 layers
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture(scope="module")
def bf16_setup():
    """The JAX package's bf16 tree (``init_params(..., dtype=bfloat16)``)
    carried across by ``interop``, and the same prompts."""
    jcfg = jax_get_arch(ARCH).reduced()
    cfg = get_arch(ARCH).reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, s).astype(np.int32)
               for s in PROMPT_LENS]
    return jcfg, cfg, jparams, params, prompts


def _recording(fn, rounds, to_np):
    """``fn`` (a server decode over every slot) that also keeps each
    round's input cuts and logits, as float32 numpy arrays, and the cuts'
    dtype."""
    def decode(params, slots, x):
        out = fn(params, slots, x)
        rounds.append((to_np(x).reshape(x.shape[0], -1),
                       to_np(out[0]).reshape(x.shape[0], -1),
                       str(x.dtype).split(".")[-1]))
        return out
    return decode


@pytest.mark.parametrize("continuous", [True, False])
def test_split_serve_bf16_matches_jax(bf16_setup, continuous):
    """The bf16 twin of ``test_split_serve_matches_jax``: two slots, so
    rounds with an idle slot stack its f32 zero cut beside a bf16 cut.
    The decode batch then promotes to f32 in both packages and every
    product takes the bf16 weights as f32, as ``jnp`` does.  Per round,
    the slots in use and the batch dtype equal the JAX server's, and the
    active slots' logits are within the bf16 tolerance; the greedy token
    is held wherever the reference's top-2 logit gap exceeds twice that
    tolerance; stats and every audited byte are exact."""
    jcfg, cfg, jparams, params, prompts = bf16_setup
    program = jax_split_program.get_program(jcfg)
    towers, jserver = program.partition(jparams)
    jworkers = [JaxTowerWorker(k, program.tower_fwd(k), towers[k],
                               serve_fns=program.tower_serve_fns(k))
                for k in range(jcfg.vertical.num_clients)]
    jsrv = JaxSplitLMServer(JaxSimTransport(jworkers), jcfg, jserver,
                            cache_len=CACHE_LEN, max_batch=2,
                            continuous=continuous)
    _, server = split_program.get_program(cfg).partition(params)
    workers = [build_split_worker(k, cfg=cfg, params=params, device="cpu")
               for k in range(cfg.vertical.num_clients)]
    srv = SplitLMServer(SimTransport(workers), cfg, server, device="cpu",
                        cache_len=CACHE_LEN, max_batch=2,
                        continuous=continuous)
    jrounds, rounds = [], []
    jsrv._decode_slots = _recording(
        jsrv._decode_slots, jrounds,
        lambda a: np.asarray(a.astype(jnp.float32)))
    srv._fns.decode = _recording(srv._fns.decode, rounds,
                                 lambda t: to_numpy(t.float()))
    jtokens = _serve(jsrv, prompts, NEW_TOKENS)
    tokens = _serve(srv, prompts, NEW_TOKENS)

    assert len(rounds) == len(jrounds) == jsrv.stats["decode_rounds"]
    idle_rounds = 0
    for (x, logits, dtype), (jx, jlogits, jdtype) in zip(rounds, jrounds):
        active = np.abs(jx).sum(axis=1) > 0
        assert np.array_equal(np.abs(x).sum(axis=1) > 0, active)
        assert dtype == jdtype == ("bfloat16" if active.all()
                                   else "float32")
        idle_rounds += not active.all()
        np.testing.assert_allclose(logits[active], jlogits[active],
                                   **BF16_TOL)
        top2 = np.sort(jlogits[active], axis=1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * BF16_TOL["atol"]
        assert np.array_equal(logits[active][sure].argmax(axis=1),
                              jlogits[active][sure].argmax(axis=1))
    assert idle_rounds > 0  # the promotion was exercised
    assert [len(t) for t in tokens] == [len(t) for t in jtokens] == \
        NEW_TOKENS
    assert {k: srv.stats[k] for k in STAT_KEYS} == \
        {k: jsrv.stats[k] for k in STAT_KEYS}
    assert _tag_bytes(srv.ledger) == _tag_bytes(jsrv.ledger)


def test_prefill_logits_match_jax(setup, jax_workers):
    """The tower prefill round, the merge and the server prefill of each
    request give the JAX package's logits within 1e-4."""
    prompts = setup[4]
    jsrv = _jax_server(setup, jax_workers, cache_len=CACHE_LEN)
    srv = _port_server(setup, cache_len=CACHE_LEN)
    for rid, p in enumerate(prompts):
        jcut = jsrv.driver.prefill(rid, p, CACHE_LEN)
        jlogits, _ = jsrv._server_prefill(jsrv.server_params,
                                          jsrv._fresh_slot, jcut)
        cut = srv.driver.prefill(rid, torch.from_numpy(p).long(), CACHE_LEN)
        logits, _ = srv._fns.prefill(
            srv.server_params, srv._fns.init_cache(CACHE_LEN), cut)
        np.testing.assert_allclose(to_numpy(cut), np.asarray(jcut),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)


def test_cut_cache_eviction_matches_jax(setup, jax_workers):
    """Capacity for two resident cuts and one decode slot: prefill-ahead
    evicts, evicted requests are readmitted, and tokens, server stats and
    cut-cache stats all equal the JAX package's."""
    _, cfg, _, _, _ = setup
    S, n_new = 8, 4
    rng = np.random.default_rng(10)
    same = [rng.integers(0, cfg.vocab_size, S) for _ in range(4)]
    kw = dict(cache_len=CACHE_LEN, max_batch=1,
              cut_cache_bytes=2 * S * cfg.d_model * 4)
    jsrv = _jax_server(setup, jax_workers, **kw)
    srv = _port_server(setup, **kw)
    assert _serve(srv, same, [n_new] * 4) == _serve(jsrv, same, [n_new] * 4)
    assert srv.cut_cache.stats == jsrv.cut_cache.stats
    assert srv.stats == jsrv.stats
    assert srv.cut_cache.stats["evictions"] >= 2
    assert srv.stats["reprefills"] >= 1
    assert _tag_bytes(srv.ledger) == _tag_bytes(jsrv.ledger)


def test_idle_slot_past_cache_len(setup, jax_workers):
    """Slot 1 idles through three one-request runs — more decode rounds
    than the cache holds — while its index keeps advancing.  The port
    clamps the idle slot's writes as the JAX package does; tokens stay
    identical, and slot 1 is still usable afterwards."""
    _, cfg, _, _, _ = setup
    cache_len, S, n_new = 16, 4, 7
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab_size, S) for _ in range(3)]
    jsrv = _jax_server(setup, jax_workers, cache_len=cache_len, max_batch=2)
    srv = _port_server(setup, cache_len=cache_len, max_batch=2)
    for p in prompts:
        assert _serve(srv, [p], [n_new]) == _serve(jsrv, [p], [n_new])
    idle_index = int(srv._slots["index"][1])
    assert idle_index == 3 * (n_new - 1) > cache_len
    assert idle_index == int(jsrv._slots["index"][1])
    # both slots busy now: the overrun slot is overwritten at admit
    both = [rng.integers(0, cfg.vocab_size, S) for _ in range(2)]
    assert _serve(srv, both, [n_new] * 2) == _serve(jsrv, both, [n_new] * 2)


def test_sampling_is_per_request_deterministic(setup):
    """Temperature/top-k sampling draws from a generator seeded per
    (request, position): continuous and static batching sample identical
    streams, and another seed samples another one."""
    prompts = setup[4]
    sampling = SamplingParams(temperature=1.5, top_k=50)
    runs = []
    for continuous, seed in ((True, 3), (False, 3), (True, 4)):
        srv = _port_server(setup, cache_len=CACHE_LEN, max_batch=2,
                           continuous=continuous, sampling=sampling,
                           seed=seed)
        runs.append(_serve(srv, prompts, NEW_TOKENS))
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


def test_cut_cache_unit():
    cache = CutCache(capacity_bytes=3 * 16)  # three 4-float cuts
    cuts = {r: torch.full((1, 4), float(r)) for r in range(5)}
    for r in range(3):
        cache.put(r, cuts[r])
    assert len(cache) == 3 and cache.total_bytes == 48
    cache.pin(0)
    cache.put(3, cuts[3])  # evicts LRU unpinned = rid 1
    assert 1 not in cache and 0 in cache
    assert cache.stats["evictions"] == 1
    assert cache.get(1) is None and cache.stats["misses"] == 1
    assert float(cache.get(2)[0, 0]) == 2.0  # hit moves to MRU
    cache.put(4, cuts[4])  # now rid 3 is LRU unpinned
    assert 3 not in cache and 2 in cache
    cache.release(0)
    assert 0 not in cache
    assert not CutCache(capacity_bytes=16).can_admit(17)
    with pytest.raises(ValueError):
        CutCache(capacity_bytes=0)


def test_admission_control_and_guards(setup):
    _, cfg, _, _, _ = setup
    srv = _port_server(setup, cache_len=CACHE_LEN,
                       cut_cache_bytes=4 * cfg.d_model * 4)
    with pytest.raises(ValueError, match="admission control"):
        srv.submit(np.zeros(8, np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="cache slots"):
        srv.submit(np.zeros(4, np.int32), max_new_tokens=CACHE_LEN)
    with pytest.raises(ValueError, match="max_new_tokens"):
        srv.submit(np.zeros(2, np.int32), max_new_tokens=0)
    # the worker checks the driver's position against its session clock
    worker = srv.driver.transport.workers[0]
    worker.handle({"op": "serve_prefill", "request": 7, "tokens": [1, 2, 3],
                   "cache_len": 8})
    with pytest.raises(ValueError, match="position mismatch"):
        worker.handle({"op": "serve_decode", "request": 7, "token": 4,
                       "pos": 5})
    with pytest.raises(ValueError, match="unknown op"):
        worker.handle({"op": "serve_rewind"})
    # secure aggregation's key exchange is a worker op now; a request
    # without its phase fails loudly, as the JAX package's worker does
    with pytest.raises(KeyError, match="phase"):
        worker.handle({"op": "key_exchange"})


def test_training_overlays_rejected(setup):
    """Serving ships raw cut frames: a compressed config is refused by the
    server and by the worker's own guard, through the compat matrix."""
    _, cfg, _, params, _ = setup
    ccfg = cfg.with_vertical(VerticalConfig(num_clients=2, tower_layers=1,
                                            compression="int8"))
    _, server = split_program.get_program(ccfg).partition(params)
    worker = build_split_worker(0, cfg=ccfg, params=params, device="cpu")
    with pytest.raises(compat.CompatError, match="raw cut frames"):
        SplitLMServer(SimTransport([worker, worker]), ccfg, server,
                      cache_len=CACHE_LEN, device="cpu")
    with pytest.raises(compat.CompatError, match="raw cut frames"):
        worker.handle({"op": "serve_prefill", "request": 0, "tokens": [1],
                       "cache_len": 4})


def test_entry_points_default_to_cuda(setup):
    """Without device="cpu" the entry points want the card, and raise
    where there is none — never a silent fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    _, cfg, _, params, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backbone.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_split_worker(0, cfg=cfg, params=params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _, server = split_program.get_program(cfg).partition(params)
        SplitLMServer(SimTransport([]), cfg, server, cache_len=CACHE_LEN)


def _imports(path: Path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_imports_neither_jax_nor_repro():
    """The port and its chip scripts import torch and numpy, never jax and
    nothing of the JAX package — checked by AST and by importing the
    serving, training, optimizer and data packages, the kernel build, the
    flash-attention and SSD modules, the ssm model, the paper MLP's
    modules, the simulation layer and the no-wait modules with both
    blocked."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_profile.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; import repro_torch.serve, "
            "repro_torch.transport, repro_torch.kernels.ops, "
            "repro_torch.kernels.build, repro_torch.kernels.flash_attention, "
            "repro_torch.models.attention, "
            "repro_torch.kernels.ssd_scan, repro_torch.models.mamba, "
            "repro_torch.models.backbone, repro_torch.configs.mamba2_1_3b, "
            "repro_torch.optim, repro_torch.data.loader, "
            "repro_torch.train.loop, repro_torch.runtime.pipeline, "
            "repro_torch.core.split_model, repro_torch.core.dropping, "
            "repro_torch.core.partition, repro_torch.data.synthetic, "
            "repro_torch.optim.sgd, repro_torch.configs.vertical_mlp, "
            "repro_torch.runtime, repro_torch.runtime.engine, "
            "repro_torch.runtime.clock, repro_torch.runtime.links, "
            "repro_torch.runtime.topology, repro_torch.runtime.deadline, "
            "repro_torch.core.straggler, repro_torch.core.costs, "
            "repro_torch.core.secure_agg, repro_torch.core.compression; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
