"""Where split serving's time goes on one NVIDIA GPU: a ``torch.profiler``
breakdown of the PyTorch port serving full-width smollm-360m.

    python3 chip_profile.py      # from the repo root; needs one CUDA card

Serves the traffic of ``chip_smoke.py`` (8 greedy requests, prompts of
64-1024 tokens, 8-48 new tokens, K = 4 towers, 4 slots) twice under the
profiler: once with one new token per request (prefill only) and once in
full.  For each run it prints the wall time, the device's busy and idle
share (kernel time summed over the wall time; the port runs on one
stream), the number of kernel launches, the host-to-device syncs, and the
kernels and host ops that take the most time.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke  # also puts src/ on sys.path for the next two
from repro_torch.configs.base import get_arch
from repro_torch.models import backbone

CACHE_LEN = max(s + n for s, n in zip(smoke.PROMPT_LENS, smoke.NEW_TOKENS))

TOP = 12


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def profiled_run(cfg, params, prompts, new_tokens, card: str, label: str):
    srv = smoke.make_server(cfg, params, "cuda", cache_len=CACHE_LEN,
                             max_batch=4)
    for p, n in zip(prompts, new_tokens):
        srv.submit(p, max_new_tokens=n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    syncs = sum(e.count for e in host if e.key == "aten::_local_scalar_dense")
    rounds = srv.stats["decode_rounds"]
    smoke.log(f"[{label}] wall {wall:.4f} s, device busy {busy_us / 1e6:.4f} "
              f"s ({100 * busy_us / 1e6 / wall:.1f}% busy, "
              f"{100 - 100 * busy_us / 1e6 / wall:.1f}% idle), "
              f"{launches} kernel launches, {syncs} device-to-host reads, "
              f"{rounds} decode rounds, {srv.stats['prefills']} prefills "
              f"| {card}")
    for e in sorted(kernels, key=_device_us, reverse=True)[:TOP]:
        smoke.log(f"[{label}]   device {_device_us(e) / 1e3:10.3f} ms "
                  f"{e.count:7d}x  {e.key[:90]}")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:TOP]:
        smoke.log(f"[{label}]   host self {e.self_cpu_time_total / 1e3:10.3f}"
                  f" ms {e.count:7d}x  {e.key[:90]}")
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: needs one CUDA card")
    card = smoke.card_line()
    smoke.log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch("smollm-360m")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    params = backbone.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(smoke.SEED)
    prompts = [rng.integers(0, cfg.vocab_size, s) for s in smoke.PROMPT_LENS]
    smoke.serve(cfg, params, prompts[:2], [2, 2], cache_len=CACHE_LEN,
                max_batch=4)  # warm-up: Triton compiles, cuBLAS starts
    profiled_run(cfg, params, prompts, [1] * len(prompts), card, "prefill")
    profiled_run(cfg, params, prompts, smoke.NEW_TOKENS, card, "full")


if __name__ == "__main__":
    main()
