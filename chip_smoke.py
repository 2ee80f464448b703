"""Port smoke test on one NVIDIA GPU: the PyTorch port's split serving of
full-width smollm-360m, with its merge kernels in Triton.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card

Phases, in order; any failure raises and the script exits non-zero:

1. The card: require CUDA, print ``nvidia-smi``'s name and power limit,
   switch TF32 off (f32 matmuls in full f32, as the CPU path and the JAX
   package compute them; TF32 keeps ~3 decimal digits and would break
   logit parity and greedy-token identity between runs).
2. The kernels against their plain PyTorch version on CUDA tensors: every
   strategy, f32 and bf16, a dropped client, all dropped, a ragged shape,
   and the serving path's shapes; per path shape, the kernel's time, the
   plain version's, one PyTorch call's (``library_ms``) and the bound.
3. The slice: full-width smollm-360m (random weights from a seed), K = 4
   ``TowerWorker``s over ``SimTransport``, ``SplitLMServer`` continuous
   with 4 slots, 8 greedy requests.  Every merge must go through the
   kernel (launch counters reset just before the run, read just after);
   static batching and a plain-merge run must give identical tokens; a
   reduced model on the card must match the CPU path.  The concat merge
   is served the same way, through its own kernel.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the ``kernels`` JSON object.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.kernels import merge_pool as mp  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import backbone, split_program  # noqa: E402
from repro_torch.serve import SplitLMServer  # noqa: E402
from repro_torch.transport import SimTransport, build_split_worker  # noqa: E402

SEED = 0
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
L2_BYTES = 50 * 2 ** 20
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
STRATEGIES = ("sum", "avg", "max", "mul", "concat")
# the serving path's stacks: prefill (4, S, 960), decode (4, 1, 960); the
# concat merge's cut is d_model / K = 240 wide
PATH_SHAPES = [(4, 128, 960), (4, 1024, 960), (4, 1, 960)]
CONCAT_PATH_SHAPES = [(4, 128, 240), (4, 1024, 240), (4, 1, 240)]
# traffic: prompt lengths spread over 64..1024, 8..48 new tokens each
PROMPT_LENS = [64, 1024, 200, 512, 96, 768, 320, 900]
NEW_TOKENS = [48, 8, 32, 16, 40, 24, 12, 36]


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


# ---------------------------------------------------------------------------
# phase 2: kernels against the plain version
# ---------------------------------------------------------------------------

def _live(k: int, kind: str, device) -> torch.Tensor:
    live = torch.ones(k, dtype=torch.float32, device=device)
    if kind == "dropped":
        live[k // 2] = 0.0
    elif kind == "none":
        live.zero_()
    return live


def check_kernels() -> dict:
    """Every strategy x dtype x live mask x shape: kernel vs plain.
    Returns the largest f32 |error| per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"merge_reduce_kernel": 0.0, "merge_concat_kernel": 0.0}
    shapes = [(3, 37, 100), (5, 100, 384)] + PATH_SHAPES
    n = 0
    for strategy in STRATEGIES:
        name = ("merge_concat_kernel" if strategy == "concat"
                else "merge_reduce_kernel")
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("all", "dropped", "none"):
                for shape in shapes + (CONCAT_PATH_SHAPES
                                       if strategy == "concat" else []):
                    x = torch.randn(shape, generator=gen, device="cuda"
                                    ).to(dtype)
                    live = _live(shape[0], kind, "cuda")
                    got = mp.merge_pool(x, live, strategy=strategy)
                    want = ref.merge_pool(x, strategy, live)
                    torch.cuda.synchronize()
                    if got.shape != want.shape:
                        raise AssertionError(
                            f"{name} {strategy} {shape}: shape "
                            f"{tuple(got.shape)} != {tuple(want.shape)}")
                    torch.testing.assert_close(
                        got.float(), want.float(), rtol=TOL[dtype],
                        atol=TOL[dtype])
                    if dtype == torch.float32:
                        err = float((got - want).abs().max())
                        worst[name] = max(worst[name], err)
                    n += 1
    log(f"kernels: {n} cases match the plain version "
        f"(f32 tol 1e-5, bf16 tol 2e-2); worst f32 |err| {worst}")
    return worst


def time_ms(fn, inputs: list, iters: int = 200) -> float:
    """Mean device time per call over ``iters`` calls, CUDA events, after a
    warm-up; inputs rotate over buffers that together exceed the L2 cache,
    so each call reads device memory as a cold caller would."""
    for args in inputs[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, inputs: list, iters: int = 50, reps: int = 5) -> float:
    """Device time per call without the host's launch cost: ``iters`` calls
    captured in one CUDA graph, the graph replayed ``reps`` times between
    CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        for args in inputs[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def bound(shape, itemsize: int, concat: bool) -> tuple[float, str]:
    """Least time on an H100 SXM for one call: the bytes the function must
    move (stack and live flags read once, output written once) over the
    memory rate, vs its flops over the f32 rate; the larger wins."""
    K, B, D = shape
    nbytes = K * B * D * itemsize + K * 4 + (K if concat else 1) * B * D * \
        itemsize
    flops = K * B * D if concat else 2 * K * B * D
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_call(strategy: str):
    """One PyTorch call computing the same function on all-live input."""
    return {
        "sum": lambda x: torch.sum(x, 0),
        "avg": lambda x: torch.mean(x, 0),
        "max": lambda x: torch.amax(x, 0),
        "mul": lambda x: torch.prod(x, 0),
        "concat": lambda x: torch.cat(x.unbind(0), 1),
    }[strategy]


def time_path_shapes(card: str) -> dict:
    """Times at the serving path's shapes (all clients live, as served)."""
    rows = {}
    for strategy, shapes in (("avg", PATH_SHAPES),
                             ("concat", CONCAT_PATH_SHAPES)):
        concat = strategy == "concat"
        for shape in shapes:
            K, B, D = shape
            nbytes = K * B * D * 4
            n_buf = min(16, max(1, math.ceil(2 * L2_BYTES / nbytes)))
            bufs = [torch.randn(shape, device="cuda") for _ in range(n_buf)]
            live = torch.ones(K, dtype=torch.float32, device="cuda")
            kern = [(b, live) for b in bufs]
            fns = {
                "": lambda x, lv: mp.merge_pool(x, lv, strategy=strategy),
                "plain_": lambda x, lv: ref.merge_pool(x, strategy, lv),
                "library_": lambda x, lv: library_call(strategy)(x),
            }
            row = {}
            for prefix, fn in fns.items():
                row[prefix + "ms"] = time_ms(fn, kern)
                row[prefix + "device_ms"] = device_ms(fn, kern)
            row["bound_ms"], row["bound_by"] = bound(shape, 4, concat)
            rows[(strategy, shape)] = row
            log(f"time {strategy} f32 {shape}: per call (device, launch cost "
                f"removed): kernel {row['ms']:.6f} ({row['device_ms']:.6f}) "
                f"ms, plain {row['plain_ms']:.6f} "
                f"({row['plain_device_ms']:.6f}) ms, library "
                f"{row['library_ms']:.6f} ({row['library_device_ms']:.6f}) "
                f"ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}) "
                f"| {card}")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------

def make_server(cfg, params, device, **kw):
    program = split_program.get_program(cfg)
    _, server = program.partition(params)
    workers = [build_split_worker(k, cfg=cfg, params=params, device=device)
               for k in range(cfg.vertical.num_clients)]
    return SplitLMServer(SimTransport(workers), cfg, server, device=device,
                         **kw)


def serve(cfg, params, prompts, new_tokens, **kw):
    """One serving run on a fresh server; returns (tokens, stats, seconds,
    launches during the run)."""
    srv = make_server(cfg, params, "cuda", **kw)
    for p, n in zip(prompts, new_tokens):
        srv.submit(p, max_new_tokens=n)
    torch.cuda.synchronize()
    mp.reset_launches()
    t0 = time.perf_counter()
    results = srv.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(mp.launches)
    if len(results) != len(prompts):
        raise AssertionError(f"{len(results)} of {len(prompts)} requests "
                             "completed")
    for r, n in zip(results, new_tokens):
        if len(r.tokens) != n:
            raise AssertionError(f"request {r.rid}: {len(r.tokens)} tokens, "
                                 f"asked for {n}")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.rid}: token out of vocab")
    return [r.tokens for r in results], dict(srv.stats), seconds, launches


def expect_merges(stats, new_tokens, launches, kernel: str) -> int:
    """Every merge went through ``kernel``: one per prefill round plus one
    per request per decode round."""
    merges = stats["prefills"] + sum(n - 1 for n in new_tokens)
    other = [k for k in launches if k != kernel]
    if launches[kernel] != merges or any(launches[k] for k in other):
        raise AssertionError(f"launches {launches}, expected {merges} of "
                             f"{kernel} and no other")
    return merges


def check_small_against_cpu() -> None:
    """Reduced smollm-360m, same weights: the card (kernels) against the
    CPU path (plain versions) — prefill logits within 1e-4, identical
    greedy tokens."""
    cfg = get_arch("smollm-360m").reduced()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    cpu_params = backbone.init_params(cfg, gen, device="cpu")
    gpu_params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, s) for s in (8, 5, 12, 7)]
    new = [6, 9, 4, 8]
    out = {}
    for device, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        srv = make_server(cfg, params, device, cache_len=32, max_batch=2)
        cut = srv.driver.prefill(0, torch.as_tensor(prompts[0], device=device),
                                 32)
        logits, _ = srv._fns.prefill(srv.server_params,
                                     srv._fns.init_cache(32, device=device),
                                     cut)
        for p, n in zip(prompts, new):
            srv.submit(p, max_new_tokens=n)
        out[device] = (logits.cpu(), [r.tokens for r in srv.run()])
    if not torch.isfinite(out["cuda"][0]).all():
        raise AssertionError("non-finite prefill logits on the card")
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    if out["cuda"][1] != out["cpu"][1]:
        raise AssertionError("reduced model: card tokens differ from CPU")
    log("small: reduced smollm-360m on the card matches the CPU path "
        "(prefill logits within 1e-4, identical greedy tokens)")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def serve_full(card: str) -> dict:
    cfg = get_arch("smollm-360m")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = backbone.init_params(cfg, gen, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, s) for s in PROMPT_LENS]
    cache_len = max(s + n for s, n in zip(PROMPT_LENS, NEW_TOKENS))
    kw = dict(cache_len=cache_len, max_batch=4)
    log(f"model: {cfg.name} full width, {n_params} params f32, K="
        f"{cfg.vertical.num_clients} towers, merge {cfg.vertical.merge}, "
        f"cache_len {cache_len}")

    # warm-up: Triton compiles, cuBLAS initializes (not measured)
    serve(cfg, params, prompts[:2], [2, 2], **kw)

    # prefill only: one token per request, no decode round
    _, pstats, t_prefill, plaunch = serve(cfg, params, prompts,
                                          [1] * len(prompts), **kw)
    expect_merges(pstats, [1] * len(prompts), plaunch, "merge_reduce_kernel")

    # the main path: continuous batching; counts reset just before
    torch.cuda.reset_peak_memory_stats()
    tokens, stats, t_main, launches = serve(cfg, params, prompts, NEW_TOKENS,
                                            continuous=True, **kw)
    peak = torch.cuda.max_memory_allocated()
    merges = expect_merges(stats, NEW_TOKENS, launches, "merge_reduce_kernel")

    static, sstats, t_static, slaunch = serve(
        cfg, params, prompts, NEW_TOKENS, continuous=False, **kw)
    expect_merges(sstats, NEW_TOKENS, slaunch, "merge_reduce_kernel")
    if static != tokens:
        raise AssertionError("static batching gave other tokens")

    plain, _, t_plain, plaunch = serve(cfg, params, prompts, NEW_TOKENS,
                                       use_kernel=False, **kw)
    if any(plaunch.values()):
        raise AssertionError(f"plain-merge run launched kernels: {plaunch}")
    if plain != tokens:
        raise AssertionError("the plain merge gave other tokens")

    prefill_tokens = sum(PROMPT_LENS)
    decode_tokens = sum(NEW_TOKENS) - len(NEW_TOKENS)
    t_decode = t_main - t_prefill
    log(f"serve continuous: {len(prompts)} requests, {stats['tokens']} "
        f"tokens, {stats['decode_rounds']} decode rounds, {merges} merges = "
        f"{launches['merge_reduce_kernel']} merge_reduce_kernel launches "
        f"({merges / len(prompts):.2f} per request) | {card}")
    log(f"serve: prefill {prefill_tokens / t_prefill:.1f} tok/s "
        f"({prefill_tokens} prompt tokens in {t_prefill:.4f} s, "
        f"max_new_tokens=1 run); decode {decode_tokens / t_decode:.1f} tok/s "
        f"({decode_tokens} tokens in the {t_decode:.4f} s the full run took "
        f"beyond the prefill run); wall continuous {t_main:.4f} s, static "
        f"{t_static:.4f} s ({sstats['decode_rounds']} rounds), plain-merge "
        f"{t_plain:.4f} s; max_memory_allocated {peak} bytes | {card}")
    del params

    # the concat merge: the same path through merge_concat_kernel
    ccfg = cfg.with_vertical(dataclasses.replace(cfg.vertical,
                                                 merge="concat"))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cparams = backbone.init_params(ccfg, gen, device="cuda")
    cprompts, cnew = prompts[:4], NEW_TOKENS[:4]
    ctokens, cstats, t_concat, claunch = serve(ccfg, cparams, cprompts, cnew,
                                               **kw)
    cmerges = expect_merges(cstats, cnew, claunch, "merge_concat_kernel")
    cplain, _, _, _ = serve(ccfg, cparams, cprompts, cnew, use_kernel=False,
                            **kw)
    if cplain != ctokens:
        raise AssertionError("concat: the plain merge gave other tokens")
    log(f"serve concat: {len(cprompts)} requests, {cmerges} merges = "
        f"{claunch['merge_concat_kernel']} merge_concat_kernel launches, "
        f"wall {t_concat:.4f} s | {card}")
    return {"merge_reduce_kernel": launches["merge_reduce_kernel"],
            "merge_concat_kernel": claunch["merge_concat_kernel"]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this script needs one CUDA card")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    worst = check_kernels()
    rows = time_path_shapes(card)
    check_small_against_cpu()
    launches = serve_full(card)

    kernels = []
    for name, strategy, shape, replaces in (
            ("merge_reduce_kernel", "avg", (4, 1024, 960),
             "src/repro/kernels/merge_pool.py:29"),
            ("merge_concat_kernel", "concat", (4, 1024, 240),
             "src/repro/kernels/merge_pool.py:67")):
        row = rows[(strategy, shape)]
        kernels.append({
            "name": name, "route": "triton",
            "source": "src/repro_torch/kernels/merge_pool.py",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"],
            "plain_device_ms": row["plain_device_ms"],
            "library_device_ms": row["library_device_ms"],
            "shape": list(shape), "dtype": "float32"})
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
