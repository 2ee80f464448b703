"""Where split serving's, split training's and long-prompt serving's time
goes on one NVIDIA GPU: a ``torch.profiler`` breakdown of the PyTorch
port on full-width smollm-360m, mamba2-1.3b and starcoder2-3b.

    python3 chip_profile.py      # from the repo root; needs one CUDA card
    python3 chip_profile.py starcoder   # only some sections, by name:
                                        # serve, train, long, ssm, starcoder,
                                        # ssmtrain, generate, longtrain

Serves the traffic of ``chip_smoke.py`` (8 greedy requests, prompts of
64-1024 tokens, 8-48 new tokens, K = 4 towers, 4 slots) twice under the
profiler: once with one new token per request (prefill only) and once in
full.  Then trains as ``chip_smoke.py`` does (``train_split`` over
``InprocTransport``, K = 4, avg, batch 8 x 256 tokens, serial) for
``TRAIN_STEPS`` steps under the profiler, step-0 verification off, after
an unprofiled warm-up run.  For each run it prints the wall time, the
device's busy and idle share (kernel time summed over the wall time; the
port runs on one stream), the number of kernel launches, the
device-to-host reads, and the kernels and host ops that take the most
time.  Last, it serves ``chip_smoke.py``'s long-prompt traffic (prompts
of 2500-32768 tokens plus one of 1024) twice under the profiler, prefill
only and in full, after an unprofiled warm-up, and prints the
flash-attention kernel's share of the device time and of the wall time.
Then full-width mamba2-1.3b (``chip_smoke.py``'s phase 8): one
``forward`` of 32768 tokens and greedy ``generate`` of 4 prompts of 64
tokens with 16 new tokens each, each under the profiler after an
unprofiled warm-up, with the SSD chunk kernel's share.  Last,
full-width starcoder2-3b (``chip_smoke.py``'s phase 9): the prefill of
its 32768-token prompt alone, then of all four of its prompts, one new
token each, after an unprofiled warm-up.  Last, full-width mamba2-1.3b
trained as ``chip_smoke.py``'s phase 12 does (as the smollm training
run above, 8 x 256 tokens a step), with the SSD forward and backward
kernels' shares.  Last, monolithic dense serving of full-width
smollm-360m (``chip_smoke.py``'s phase 13): ``prefill_tokens`` of its
4096-token prompt, then 16 decode steps over a linear cache of 4096 at
batch 1 and at batch 32, as ``batched_throughput_probe`` times them,
after an unprofiled warm-up.  Last, ``longtrain``: the smollm training
run at ``chip_smoke.py``'s phase 19 (c) shape, 2 x 4096 tokens a step,
2 steps, with the flash forward's and the four flash backward kernels'
shares.  Every run also prints the f32 GEMMs' share (kernels named
``*gemm*``: cuBLAS and CUTLASS).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke  # also puts src/ on sys.path for the next two
from repro_torch.configs.base import get_arch
from repro_torch.data.loader import LMBatchLoader
from repro_torch.models import backbone
from repro_torch.serve import generate
from repro_torch.train.loop import train_split

CACHE_LEN = max(s + n for s, n in zip(smoke.PROMPT_LENS, smoke.NEW_TOKENS))
TRAIN_STEPS = 4

TOP = 12


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def profiled(fn, card: str, label: str, describe, host_ops=()) -> None:
    """Run ``fn()`` under the profiler and print the breakdown;
    ``describe(result, launches, syncs)`` adds the run's own counts, and
    each ``(op, meaning)`` of ``host_ops`` the device time of the kernels
    that host op launched."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    syncs = sum(e.count for e in host if e.key == "aten::_local_scalar_dense")
    smoke.log(f"[{label}] wall {wall:.4f} s, device busy {busy_us / 1e6:.4f} "
              f"s ({100 * busy_us / 1e6 / wall:.1f}% busy, "
              f"{100 - 100 * busy_us / 1e6 / wall:.1f}% idle), "
              f"{launches} kernel launches, {syncs} device-to-host reads, "
              f"{describe(result, launches, syncs)} | {card}")
    for e in sorted(kernels, key=_device_us, reverse=True)[:TOP]:
        smoke.log(f"[{label}]   device {_device_us(e) / 1e3:10.3f} ms "
                  f"{e.count:7d}x  {e.key[:90]}")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:TOP]:
        smoke.log(f"[{label}]   host self {e.self_cpu_time_total / 1e3:10.3f}"
                  f" ms {e.count:7d}x  {e.key[:90]}")
    for name in ("flash_attention_kernel",
                 "flash_attention_bwd_preprocess_kernel",
                 "flash_attention_bwd_dkdv_kernel",
                 "flash_attention_bwd_reduce_kernel",
                 "flash_attention_bwd_dq_kernel",
                 "ssd_chunk_kernel", "ssd_chunk_bwd_kernel",
                 "ssd_chunk_bwd_reduce_kernel", "gemm"):
        mine = [e for e in kernels if name in e.key.lower()]
        if mine:
            us = sum(_device_us(e) for e in mine)
            smoke.log(f"[{label}]   {name}: {sum(e.count for e in mine)} "
                      f"launches, device {us / 1e3:.3f} ms = "
                      f"{100 * us / busy_us:.1f}% of device busy, "
                      f"{100 * us / 1e6 / wall:.1f}% of wall")
    for op, meaning in host_ops:
        mine = [e for e in host if e.key == op]
        us = sum(getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0)) for e in mine)
        smoke.log(f"[{label}]   {op} ({meaning}): "
                  f"{sum(e.count for e in mine)} calls, device "
                  f"{us / 1e3:.3f} ms = {100 * us / busy_us:.1f}% of device "
                  "busy")
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")


def profile_serving(cfg, params, prompts, new_tokens, card: str,
                    label: str, **kw) -> None:
    kw = dict(dict(cache_len=CACHE_LEN, max_batch=4), **kw)
    srv = smoke.make_server(cfg, params, "cuda", **kw)
    for p, n in zip(prompts, new_tokens):
        srv.submit(p, max_new_tokens=n)
    profiled(srv.run, card, label, lambda _, launches, syncs: (
        f"{srv.stats['decode_rounds']} decode rounds, "
        f"{srv.stats['prefills']} prefills"))


def run_training(cfg, params, steps: int, batch: int = smoke.TRAIN_BATCH,
                 seq: int = smoke.TRAIN_SEQ):
    loader = LMBatchLoader(cfg, batch, seq, seed=smoke.SEED)
    return train_split(cfg, loader, steps=steps, batch=batch, seq=seq,
                       runtime="serial", learning_rate=3e-4, warmup=20,
                       seed=smoke.SEED, verify_step0=False, device="cuda",
                       params=params, print_fn=lambda *a: None)


def profile_training(cfg, params, card: str, label: str = "train",
                     batch: int = smoke.TRAIN_BATCH,
                     seq: int = smoke.TRAIN_SEQ,
                     steps: int = TRAIN_STEPS) -> None:
    # warm-up: cuBLAS's backward paths start
    run_training(cfg, params, 1, batch, seq)
    # the token streams are numpy on the host, outside the profiler's ops:
    # role 0 and every worker draw one batch per step
    loader = LMBatchLoader(cfg, batch, seq, seed=smoke.SEED)
    t0 = time.perf_counter()
    for _ in range(3):
        loader.next_batch()
    smoke.log(f"[{label}] host: one {batch} x {seq} token batch takes "
              f"{(time.perf_counter() - t0) / 3:.4f} s; "
              f"{1 + cfg.vertical.num_clients} streams draw one per step")

    def describe(result, launches, syncs):
        times = result[1].step_times
        return (f"{steps} steps (step wall {times} s), "
                f"{launches / steps:.1f} launches and "
                f"{syncs / steps:.1f} device-to-host reads per step")

    profiled(lambda: run_training(cfg, params, steps, batch, seq), card,
             label, describe)


def profile_ssm(card: str) -> None:
    cfg = get_arch("mamba2-1.3b")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    params = backbone.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(smoke.SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 32768)),
                             device="cuda")
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)),
                              device="cuda")
    backbone.forward(params, {"tokens": tokens[:, :2048]}, cfg)  # warm-up
    generate(params, cfg, prompts[:, :8], max_new_tokens=2)
    profiled(lambda: backbone.forward(params, {"tokens": tokens}, cfg)[0],
             card, "ssm prefill 32768", lambda *_: "one request, B = 1",
             host_ops=[("aten::einsum", "the inter-chunk recurrence of "
                        "ops.ssd_scan, its only caller on this path")])
    profiled(lambda: generate(params, cfg, prompts, max_new_tokens=16),
             card, "ssm generate", lambda _, launches, syncs: (
                 f"{launches / (64 + 15):.1f} launches per decode step "
                 "(64 replay + 15 decode steps)"))


def profile_ssm_training(card: str) -> None:
    cfg = get_arch("mamba2-1.3b")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    params = backbone.init_params(cfg, gen, device="cuda")
    profile_training(cfg, params, card, "ssm train")


def profile_starcoder(card: str) -> None:
    cfg = get_arch(smoke.SC_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    params = backbone.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(smoke.SEED)  # chip_smoke's prompts
    prompts = [rng.integers(0, cfg.vocab_size, s) for s in smoke.SC_PROMPTS]
    kw = smoke.sc_serving_kw(cfg)
    smoke.serve(cfg, params, prompts[:1], [2], **kw)  # warm-up
    longest = smoke.SC_PROMPTS.index(max(smoke.SC_PROMPTS))
    profile_serving(cfg, params, [prompts[longest]], [1], card,
                    f"starcoder prefill {max(smoke.SC_PROMPTS)}", **kw)
    profile_serving(cfg, params, prompts, [1] * len(prompts), card,
                    "starcoder long prefill", **kw)
    del params
    torch.cuda.empty_cache()


def profile_generate(card: str) -> None:
    """Monolithic dense serving: the prompt prefill and decode steps."""
    cfg = get_arch("smollm-360m")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    params = backbone.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(smoke.SEED)
    rng.integers(0, cfg.vocab_size, smoke.MONO_SHORT)  # chip_smoke's draws
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, smoke.MONO_LONG)), device="cuda")
    generate(params, cfg, prompt[:, :2304], max_new_tokens=2)  # warm-up
    profiled(lambda: smoke.mono_prefill(cfg, params, prompt)[0], card,
             f"mono prefill {smoke.MONO_LONG}", lambda *_: "one request")
    step = backbone.make_serve_step(cfg)
    steps = smoke.MONO_PROBE_STEPS
    for batch in (1, 32):
        cache = backbone.init_cache(cfg, batch, smoke.MONO_PROBE_LEN,
                                    device="cuda")
        tok = torch.zeros((batch,), dtype=torch.long, device="cuda")
        step(params, cache, tok)  # warm-up

        def decode(cache=cache, tok=tok):
            for _ in range(steps):
                _, cache = step(params, cache, tok)

        profiled(decode, card, f"mono decode b{batch} {smoke.MONO_PROBE_LEN}",
                 lambda _, launches, syncs: (
                     f"{steps} steps, {launches / steps:.1f} launches a "
                     "step"),
                 host_ops=[("aten::einsum", "decode attention's scores "
                            "and values")])
        del cache
        torch.cuda.empty_cache()


def profile_smollm(card: str, sections) -> None:
    """The serve, train, long and longtrain sections, on full-width
    smollm-360m."""
    cfg = get_arch("smollm-360m")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    params = backbone.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(smoke.SEED)
    prompts = [rng.integers(0, cfg.vocab_size, s) for s in smoke.PROMPT_LENS]
    smoke.serve(cfg, params, prompts[:2], [2, 2], cache_len=CACHE_LEN,
                max_batch=4)  # warm-up: nvcc build, cuBLAS starts
    if "serve" in sections:
        profile_serving(cfg, params, prompts, [1] * len(prompts), card,
                        "prefill")
        profile_serving(cfg, params, prompts, smoke.NEW_TOKENS, card, "full")
    if "train" in sections:
        profile_training(cfg, params, card)
    if "longtrain" in sections:
        profile_training(cfg, params, card, "long train", smoke.LT_BATCH,
                         smoke.LT_SEQ, steps=2)
    if "long" in sections:
        rng = np.random.default_rng(smoke.SEED)  # chip_smoke's long prompts
        long_prompts = [rng.integers(0, cfg.vocab_size, s)
                        for s in smoke.LONG_PROMPTS]
        kw = dict(cache_len=max(s + n for s, n in zip(smoke.LONG_PROMPTS,
                                                      smoke.LONG_NEW)),
                  max_batch=4, cut_cache_bytes=smoke.LONG_CUT_CACHE_BYTES)
        smoke.serve(cfg, params, long_prompts[:1], [2], **kw)  # warm-up
        profile_serving(cfg, params, long_prompts, [1] * len(long_prompts),
                        card, "long prefill", **kw)
        profile_serving(cfg, params, long_prompts, smoke.LONG_NEW, card,
                        "long full", **kw)


SECTIONS = ("serve", "train", "long", "ssm", "starcoder", "ssmtrain",
            "generate", "longtrain")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: needs one CUDA card")
    sections = sys.argv[1:] or SECTIONS
    if set(sections) - set(SECTIONS):
        raise SystemExit(f"chip_profile: sections are {SECTIONS}")
    card = smoke.card_line()
    smoke.log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if {"serve", "train", "long", "longtrain"} & set(sections):
        profile_smollm(card, sections)
        torch.cuda.empty_cache()
    if "ssm" in sections:
        profile_ssm(card)
    if "starcoder" in sections:
        profile_starcoder(card)
        torch.cuda.empty_cache()
    if "ssmtrain" in sections:
        profile_ssm_training(card)
        torch.cuda.empty_cache()
    if "generate" in sections:
        profile_generate(card)


if __name__ == "__main__":
    main()
