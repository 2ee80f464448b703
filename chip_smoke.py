"""Port smoke test on one NVIDIA GPU: the PyTorch port's split serving,
split training and long-prompt split serving of full-width smollm-360m,
with its four merge kernels (the reductions and the concat, forward and
backward) in CUDA C++ and its flash-attention kernel in CUDA C++ on the
tensor cores (3xTF32), the full-sequence forward and greedy generation
of full-width mamba2-1.3b with its SSD chunk kernel in CUDA C++ on the
tensor cores (3xTF32), long-prompt split serving of full-width
starcoder2-3b, whose attention (head dim 128) runs the flash kernel's
wider instantiation, the paper's own experiment: vertically split
MLP training on the three financial stand-in datasets, through the
Executor and the merge kernels, no-wait split training with a
straggler (the simulated clock, adaptive deadlines and EMA imputation),
whose imputed merges run the reduce kernels both ways, and split training
of full-width mamba2-1.3b, whose every Mamba2 layer runs the SSD chunk
kernel forward and its hand-written backward kernel, and monolithic
dense serving of full-width smollm-360m (prompt prefill through the
flash kernel, decode over linear, ring and int8 caches, the
decode-throughput probe), and the training launcher end to end: one
spawned process per feature holder over TCP loopback, monolithic and
centralized training with msgpack checkpoints, and
``python -m repro_torch.launch.train``, and the protocol's three wire
overlays (cut compression, secure aggregation, aggregation trees) over
the inline, threaded and process transports and through the launcher.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card

Phases, in order; any failure raises and the script exits non-zero:

1. The card: require CUDA, print ``nvidia-smi``'s name and power limit,
   switch TF32 off (f32 matmuls in full f32, as the CPU path and the JAX
   package compute them; TF32 keeps ~3 decimal digits and would break
   logit parity and greedy-token identity between runs).
2. The CUDA C++ library (every source under ``kernels/csrc``, built by
   ``nvcc`` for sm_90a into ``build/kernels/`` before the first launch;
   its build time and the four merge kernels' ptxas reports printed, a
   spill fails), then the merge kernels against their plain PyTorch
   version on CUDA tensors: every strategy, f32 and bf16, a dropped
   client, all dropped, a ragged shape, and the serving and training
   paths' shapes, the MLP path's cut stacks (phase 10) and the no-wait
   smollm stack (4, 512, 960) (phase 11) and the aggregation tree's
   top-level stack (2, 2048, 960) (phase 15), forward and backward (plus mul at an exact zero and max with exact ties at the
   training and MLP shapes).  Both concat kernels, and the reductions' backward
   for sum, avg and max, must be bit-identical to their plain versions
   (mul within the backward tolerance) there and on their scalar and
   runtime-K paths (D = 7, B = 1, K = 10, views at an odd storage offset),
   and give NaN where the plain versions do when a dropped client holds a
   NaN or an Inf (the reductions' max and mul backward: no NaN at all).
   Per path shape (the MLP path's: max both ways at its three stacks,
   concat both ways at (4, 256, 64); no-wait's: avg both ways at
   (4, 512, 960); the tree's: sum both ways at (2, 2048, 960)), the
   kernel's time, the plain
   version's, one PyTorch call's (``library_ms``) and the bound; for the
   concat forward also the one-copy library call ``x.transpose(0,
   1).reshape(B, K*D)``, for the avg backward the two-call form that PRs
   12-18 timed, and for all four kernels the wrapper's host time split
   into validation, output allocation, the stream query and the ctypes
   call with its launch.
3. The slice: full-width smollm-360m (random weights from a seed), K = 4
   ``TowerWorker``s over ``SimTransport``, ``SplitLMServer`` continuous
   with 4 slots, 8 greedy requests.  Every merge must go through the
   kernel (launch counters reset just before the run, read just after);
   static batching and a plain-merge run must give identical tokens; a
   reduced model on the card must match the CPU path.  The concat merge
   is served the same way, through its own kernel.
4. The training slice: full-width smollm-360m (K = 4, avg, random weights
   from a seed) trained by ``train_split`` over ``InprocTransport``, batch
   8 x 256 tokens, 5 serial steps, lr 3e-4 with warmup 20, step 0
   verified against ``protocol_step`` at 1e-5.  Launch counters reset
   just before the run and read just after: 5 forward and 5 backward
   reduce-kernel launches (one merge per step; the verification merges
   with the plain version).  Then 2 steps of the concat merge through its
   own kernels, and 2 steps of the reduced model on the card against the
   CPU path (losses and final params within 1e-4).
5. The flash-attention kernel: its ptxas report (registers, spills) and
   the count of tensor-core instructions (HMMA / HGMMA) in its SASS from
   ``cuobjdump`` for each instantiation (head dims 32, 64, 80, 112 and
   128, f32 and bf16; a spill or an instantiation without them fails),
   then the kernel against its plain version on CUDA tensors: smollm-360m's
   server and tower shapes at S = 2500, 4096 and 8192 in the model's
   (B, S, H, D) layout, starcoder2-3b's (D 128: server at 8192 and 32768,
   towers at 8192), stablelm-3b's server (D 80) and zamba2-7b's shared
   attention (D 112) at 8192, ragged small shapes at the tile edges,
   causal and full (causal only at 32768), f32 (tol 5e-4) and bf16
   (3e-2); at each of those timed shapes (causal f32), the kernel's time
   per call and on the device, the plain version's, one library call's,
   the tensor-core bound (3xTF32) and the f32-FMA bound.
6. Long-prompt split serving: full-width smollm-360m, K = 4, 4 slots,
   greedy, prompts of 2500-32768 tokens plus one of 1024 (dense branch)
   in one batch.  Launch counters reset just before the run, read just
   after: 38 flash launches per prompt past 2048 tokens (30 server + 4 x 2
   tower layers) and one merge launch per merge.  A plain run (merge and
   attention, role 0 and towers) gives identical tokens and prefill
   logits within 1e-3, launching no kernel; the reduced model on the card
   matches the CPU path on a 2304-token prompt (logits 1e-4, tokens).
7. The SSD chunk kernel (built with the flash kernel in phase 2): its
   ptxas report and the count of HGMMA instructions in the SASS of each
   instantiation (a spill, an instantiation without them or a ptxas note
   that its wgmmas are serialized fails), the head group (HG) and block
   count it takes at every phase-8 shape, then the kernel against its
   plain version on CUDA tensors at mamba2-1.3b's server and tower
   shapes, batch 4, the reduced config's chunks and a prompt shorter than
   a chunk and phase 12's training shapes (tol 3e-4, the JAX package's),
   and the full scan (``ops.ssd_scan``) against the model's
   ``ssd_chunked`` on the card, values and, under autograd, gradients
   (within 3e-4 of each gradient's largest entry).  At the server shape
   at S = 8192 and 32768 and the tower shape at 32768: the kernel against
   its plain version (3e-4), its time per call and on the device, the
   plain version's, and the bound: the larger of its bytes and its
   operations as 3xTF32 on the tensor cores, with the f32-FMA figure
   beside it (no single PyTorch call computes the function).  Then the
   SSD backward kernel (``ssd_chunk_bwd_kernel``, 3xTF32 on the tensor
   cores, one block per (chunk, group of HG heads, batch), and its reduce
   pass over the head groups): its ptxas report (a spill or a C7515 or
   C7520 note fails), the HGMMA instructions in the SASS of every
   instantiation (none fails), the plan (HG, groups, blocks) at every
   shape, then against ``ref.ssd_chunks_bwd`` at phase 12's server and
   tower shapes, the reduced config's, one chunk per sequence, a shape
   whose last head group is partly filled and one with P 32, with every
   upstream gradient, at the server shape also with each alone and with
   a = -80 per step (each gradient within 1e-4 of the plain one's largest
   entry, all finite), two launches bit-identical; at the server and
   tower shapes its time per call and on the device, the plain backward's
   and the bound: the larger of its bytes and its operations as 3xTF32 on
   the tensor cores, with the f32-FMA figure beside it (no single PyTorch
   call computes the gradient).
8. The ssm slice: full-width mamba2-1.3b (K = 4, avg, f32, random weights
   from a seed).  ``forward`` over one request of 2048, 8192 and 32768
   tokens and over 4 x 2048, 54 SSD launches each (46 server + 4 x 2
   tower layers; counters reset just before each run, read just after),
   prefill tokens/s and peak memory; the plain run (``use_kernel=False``:
   ``ssd_chunked``) launches nothing, its logits agree within 1e-3 and
   its last-position argmax is identical wherever the plain run's top-2
   gap there exceeds 2e-3 (closer ties are printed, not held).  Greedy ``generate`` of 4
   prompts of 256 tokens, 16 new tokens each (the prompt replayed through
   the exact recurrence, no SSD launch): the first tokens equal the
   forward's argmax, the replayed logits are printed against the
   forward's.  The reduced model on the card matches the CPU path
   (forward logits 1e-4, 3 launches, generated tokens identical; decode
   replay within 2e-3 of the forward), and with a bf16 tree its greedy
   ``generate`` over the f32 decode cache matches the CPU's tokens up to
   each row's first step whose CPU top-2 gap is 6e-2 or less.
9. The starcoder2-3b slice: first reduced starcoder2-3b at head dim 128
   on the card against the CPU path on a 2304-token prompt (as in phase
   6).  Then full-width starcoder2-3b (30 layers, d_model 3072, 24 q / 2
   kv heads of 128, untied, K = 4 towers of 6 / 1 heads; f32, random
   weights from a seed; its parameter count and peak memory logged),
   served with 2 slots: prompts of 2500, 8192, 32768 and 1024 tokens with
   8, 8, 4 and 8 new tokens.  Each prompt's prefill is timed alone (time
   to first token); then the whole traffic with the counters reset just
   before the run and read just after: 36 flash launches at D = 128 per
   prompt past 2048 tokens (28 server + 4 x 2 tower layers), 108 in all,
   and one merge launch per merge.  A plain run of the prompts up to 8192
   tokens gives identical tokens and prefill logits within 1e-3; the
   32768-token prompt's logits are finite (phase 5 holds the kernel at
   that shape).
10. The paper MLP slice (Bank Marketing, Give Me Some Credit, Financial
   PhraseBank stand-ins at their published widths and full size, f32,
   random init from a seed; its merge kernels are held against their
   plain versions and timed at its cut stacks in phase 2).  First the
   paper tables' loop
   (``make_split_train_step``, AdamW 3e-3, batch 256, 400 steps over
   ``minibatches(seed=0)`` of a split held on the card) for every dataset
   and merge and the centralized baseline, and PhraseBank's max pooling
   with 1-3 of 4 clients dropped per step (masks drawn on the card) and
   at test time: each run's first 5 losses within 1e-5 of the same run
   on the CPU, both runs' test accuracy and F1, samples/s; this loop
   merges with the plain version and launches no kernel.  Last,
   PhraseBank (K = 4) through four ``build_mlp_worker``s over
   ``InprocTransport`` and the Executor's fused policy, plain SGD at 0.1:
   max for 200 steps, then 20 at 4 microbatches and 20 for each other
   merge.  Counters reset just before each run and read just after: one
   forward and one backward merge launch per microbatch; step 0's grads
   within 1e-5 of ``protocol_step``'s; the neutral policy's run (the
   plain merge) launches none and its losses match per step within 1e-5.
   Steps/s, test accuracy and, under the profiler, the device's busy
   share.  Then PhraseBank with a bf16 tree: ``split_forward`` and one
   Executor step on the card against the CPU within 3e-2.
11. No-wait split training, counters reset just before each run and read
   just after.  (a) PhraseBank at full size through
   ``engine.pipelined_step(mode="nowait")`` on the simulated clock
   (``plan_step(cfg, 256, 4)``, client 1's links and compute 20x slower),
   avg and max, 40 steps of SGD at 0.2, on the card and on its CPU from
   the same weights: client 1 misses every microbatch and no other
   client one, identical live matrices, losses within 1e-5 per step, one
   forward and one backward ``merge_reduce`` launch per microbatch on
   the card and none on the CPU, the last five losses below the first
   five; steps/s, test accuracy and F1.  (b) PhraseBank max over
   ``InprocTransport`` with client 1 sleeping 0.06 s per forward: 20
   no-wait steps with the adaptive deadline, 20 with a 0.015 s static
   window (client 1 misses every microbatch, and gets a zero tower
   gradient on each step it missed entirely) and 20 pipelined steps;
   misses per client, the deadline per step, steps/s.  (c) Full-width
   smollm-360m, ``train_split`` over inproc, batch 8 x 256 tokens, M = 4,
   5 steps, after a warm-up step: no-wait without a straggler, its
   adaptive window bootstrapped from at least 5 s (no miss, step 0
   verified within 1e-5, losses within 1e-6 of the pipelined run at the
   same M), then with client 1 sleeping 0.1 s per forward under the
   default window; one
   forward and one backward ``merge_reduce`` launch per microbatch in
   every run.
12. ssm split training, counters reset just before each run and read
   just after.  (a) Reduced mamba2-1.3b, same weights: 2 steps of 8 x 256
   tokens through ``train_split`` on the card against 2 on the CPU,
   losses and final params within 1e-4.  (b) Full-width mamba2-1.3b
   (K = 4 towers of 2 Mamba2 layers, avg, 46 server layers, f32, random
   weights from a seed) through ``train_split`` over inproc, serial,
   batch 8 x 256 tokens, 5 steps after a warm-up step, step 0 verified
   against ``protocol_step`` at 1e-5; train tokens/s over steps 1-4 and
   peak memory.  Launch counts exact in both: per step each server layer
   runs ``ssd_chunk_kernel`` once and each tower layer twice (the worker
   re-runs its forward for the vjp), every layer ``ssd_chunk_bwd_kernel``
   once, one merge each way; step 0's verification once more of each SSD
   kernel's count (its merge is the plain version).
13. Monolithic dense serving (``serve/decode.generate`` through
   ``backbone.prefill_tokens`` and ``decode_step``; the towers merge with
   the plain ``merge_stacked``, as in the JAX package).  (a) Reduced
   smollm-360m, same weights, card against CPU: ``generate`` on a linear
   cache and on a ring of 8 under window 8 (prefill logits within 1e-5,
   greedy tokens identical), 4 decode chunks over 16 steps (logits
   within 1e-5, argmax identical), and int8 KV with 4 decode chunks,
   held to the CPU's int8 run as int8 is held to f32 (K/V within one
   int8 level, relative error below 0.02, argmax agreement above 0.9:
   an input within ~1e-6 of half a step rounds to either side on the two
   devices).  (b) Full-width
   smollm-360m (f32, seeded weights): ``generate`` of 1 x 4096 prompt
   tokens with counters reset just before and read just after (38 flash
   launches: 30 server + 4 x 2 tower layers, no merge kernel), and of
   8 x 128, 32 new tokens each; greedy tokens equal ``SplitLMServer``'s
   on the same params and prompts; the 4096-token prefill's last logits
   within 1e-3 of the plain path (``use_kernel=False``, no launch);
   prefill tokens/s and peak memory.  (c) A ring cache of 256 slots
   under window 256, 4 x 128 prompt tokens and 256 new, gives the tokens
   of a linear cache under the same window.  (d) int8 KV with 4 decode
   chunks against the f32 cache over 64 steps of 4 streams: relative
   error below 0.02, argmax agreement above 0.9 (the JAX package's
   bounds).  (e) ``batched_throughput_probe``: decode tokens/s at a
   linear cache of 4096 at batch 1, 8 and 32, and at a ring of
   ``cfg.sliding_window`` (8192) at batch 8, each beside its byte bound
   (every weight and K/V slot read once).
14. The training launcher, counters reset just before each run and read
   just after (role 0's launches; a child's own launches are not
   counted: the towers launch no kernel at these shapes).  (a) Reduced
   smollm-360m, seeded on the card in role 0 and in each spawned feature
   holder: 3 steps of ``train_split`` over ``MultiprocTransport`` against
   3 over threads (losses and final params within 1e-6, per-step ledgers
   equal, one merge each way per step).  (b) Full-width smollm-360m over
   four spawned processes on the card, 5 serial steps of 8 x 256 (step 0,
   the children's warm-up, verified against ``protocol_step`` at 1e-5):
   one ``merge_reduce`` launch each way per step, train tokens/s over
   steps 1-4 beside phase 4's threads, spawn-and-connect seconds, role
   0's peak memory and the card's memory by process as ``nvidia-smi
   --query-compute-apps`` lists it (one reading at the last step, while
   every process is alive).  (c)
   Phase 3's 8 requests through ``SplitLMServer`` over four spawned
   processes: tokens equal phase 3's, bytes equal ``costs.serve_*``,
   every merge through the kernel.  (d) The monolithic ``train`` in
   process, 3 steps of 8 x 256 each: smollm-360m vertical (its msgpack
   checkpoint loaded back bit for bit) and centralized (no launch), and
   mamba2-1.3b (exactly 54 ``ssd_chunk_kernel`` and 54
   ``ssd_chunk_bwd_kernel`` launches a step: 46 server layers and 4 x 2
   tower layers, each once); train tokens/s and peak memory.  (e)
   ``python -m repro_torch.launch.train --transport multiproc --steps 3
   --batch 8 --seq 256 --json ...`` as a subprocess: exit 0, the step-0
   verification line, the summary's keys.
15. The wire overlays, counters reset just before each run and read just
   after.  (a) Reduced smollm-360m at K = 4, seeded on the card: 3 steps
   of ``train_split`` over the inline transport against 3 over threads,
   for top-k (0.25), int8, secure aggregation, a fanout-2 tree and the
   tree under secure aggregation: losses and params bit for bit (secure:
   within 1e-3, each run draws its own DH keys), the per-step ledgers
   equal and equal to ``costs`` byte for byte, one merge each way per
   step at the stack the overlay implies (avg (4, 2048, 256); sum
   (2, 2048, 256) along the tree).  (b) Full-width smollm-360m,
   ``--compress topk`` over four spawned processes, 5 serial steps: step
   0 verified at ``STEP0_VERIFY_ATOL``, 8,847,360 bytes up and down a
   step, train tokens/s beside phase 14's plain multiproc run and the
   host time ``payload_bytes`` spends in its syncs at role 0.  (c) The
   same under ``--secure-agg --agg-tree-fanout 2``: the key exchange's
   1,320 bytes once, role 0's masked step-0 sum within
   ``cancellation_bound`` of the raw sum, step 0 verified at 1e-3,
   ``merge_reduce_kernel`` at (2, 2048, 960) "sum" both ways, 15,728,640
   bytes per tree level.  (d) ``python -m repro_torch.launch.train
   --transport multiproc --compress int8 --steps 3 ...`` as a subprocess.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the ``kernels`` JSON object.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.configs.vertical_mlp import PAPER_DATASETS  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.loader import LMBatchLoader  # noqa: E402
from repro_torch.core import costs, dropping, protocol  # noqa: E402
from repro_torch.core import split_model, towers  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import merge_pool as mp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import backbone, mamba, split_program  # noqa: E402
from repro_torch.models.transformer import BlockDims  # noqa: E402
from repro_torch.optim import SGD, AdamW  # noqa: E402
from repro_torch.runtime import engine  # noqa: E402
from repro_torch.runtime.deadline import AdaptiveDeadline  # noqa: E402
from repro_torch.runtime.executor import Executor  # noqa: E402
from repro_torch.runtime.links import LinkModel  # noqa: E402
from repro_torch.serve import (SplitLMServer,  # noqa: E402
                               batched_throughput_probe, generate)
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.train.loop import train as train_mono  # noqa: E402
from repro_torch.train.loop import train_split  # noqa: E402
from repro_torch.transport import (InprocTransport,  # noqa: E402
                                   MultiprocTransport, SimTransport,
                                   WorkerSpec, build_mlp_worker,
                                   build_split_worker)
from repro_torch.tree_util import tree_map  # noqa: E402

SEED = 0
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
H100_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores, H100 SXM
L2_BYTES = 50 * 2 ** 20
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
STRATEGIES = ("sum", "avg", "max", "mul", "concat")
# the serving path's stacks: prefill (4, S, 960), decode (4, 1, 960); the
# concat merge's cut is d_model / K = 240 wide
PATH_SHAPES = [(4, 128, 960), (4, 1024, 960), (4, 1, 960)]
CONCAT_PATH_SHAPES = [(4, 128, 240), (4, 1024, 240), (4, 1, 240)]
# the training path's stacks: batch 8 x seq 256 = 2048 rows per merge
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 5
TRAIN_SHAPE, CONCAT_TRAIN_SHAPE = (4, 2048, 960), (4, 2048, 240)
# the concat kernels' scalar path: D % 4 != 0, B = 1, K = 10
CONCAT_EDGE_SHAPES = [(10, 3, 7), (4, 1, 7), (10, 1, 240), (3, 5, 6),
                      (1, 2, 1)]
# the reductions' backward: K = 1, 3, 8 and 10 (the runtime-K
# instantiation), D = 7 and B = 1 (the scalar path)
REDUCE_BWD_EDGE_SHAPES = [(1, 3, 8), (3, 5, 7), (8, 4, 12), (10, 3, 8),
                          (4, 1, 7), (8, 1, 960), (10, 1, 7)]
# the host-cost breakdown: rounds per part, calls per round
HOST_ROUNDS, HOST_CALLS = 5, 400
# traffic: prompt lengths spread over 64..1024, 8..48 new tokens each
PROMPT_LENS = [64, 1024, 200, 512, 96, 768, 320, 900]
NEW_TOKENS = [48, 8, 32, 16, 40, 24, 12, 36]
# long-prompt traffic: five prompts past the 2048-token threshold and one
# that keeps the dense branch, in one batch; a cut cache that holds the
# 126 MB cut of the 32768-token prompt beside the four pinned ones
LONG_PROMPTS = [2500, 4096, 8192, 16384, 32768, 1024]
LONG_NEW = [16, 16, 8, 8, 4, 16]
LONG_CUT_CACHE_BYTES = 256 * 2 ** 20
FLASH_TOL = {torch.float32: 5e-4, torch.bfloat16: 3e-2}
# (B, H, Hkv, S, D): the serving path's server and tower attentions
FLASH_PATH_SHAPES = [(1, h, hkv, s, 64) for s in (2500, 4096, 8192)
                     for h, hkv in ((15, 5), (3, 1))]
FLASH_SMALL_SHAPES = [(2, 4, 2, 37, 64), (1, 2, 2, 600, 32),
                      (1, 3, 1, 1, 64), (2, 6, 2, 65, 32),
                      (1, 3, 3, 129, 64), (2, 4, 2, 37, 128),
                      (1, 2, 2, 600, 80), (1, 3, 1, 97, 112),
                      (2, 6, 2, 65, 128), (1, 3, 3, 33, 80)]
# the larger head dims at the widths of the configs that need them:
# starcoder2-3b's server (24 q / 2 kv heads) at 8192 and 32768 tokens and
# its towers (6 / 1), all D 128; stablelm-3b's server (32 / 32, D 80) and
# zamba2-7b's shared attention (32 / 32, D 112).  Causal and full, except
# at 32768 (causal, as the path runs it: the plain version there takes a
# second a call).
FLASH_WIDE_SHAPES = [(1, 24, 2, 8192, 128), (1, 6, 1, 8192, 128),
                     (1, 32, 32, 8192, 80), (1, 32, 32, 8192, 112),
                     (1, 24, 2, 32768, 128)]
# timed, causal f32: the smollm-360m server (D 64) as PR 15 timed it, then
# every wide shape
FLASH_TIME_SHAPES = [(1, 15, 5, 8192, 64), (1, 15, 5, 32768, 64)] + \
    FLASH_WIDE_SHAPES
SSD_TOL = 3e-4  # the JAX package's tolerance for its SSD chunk kernel
# (B, S, H, P, N, chunk): mamba2-1.3b's server (64 heads) SSD at 2048 and
# 8192 tokens, its tower (16 heads) at 8192 and 32768, batch 4, the reduced
# config's chunks (Q 32, N 16; 8 server and 4 tower heads) and a prompt
# shorter than a chunk (Q = S = 96); the server shape at 32768 is checked
# where it is timed
SSD_SHAPES = [(1, 2048, 64, 64, 128, 128), (1, 8192, 64, 64, 128, 128),
              (1, 8192, 16, 64, 128, 128), (1, 32768, 16, 64, 128, 128),
              (4, 2048, 64, 64, 128, 128), (2, 256, 8, 64, 16, 32),
              (2, 256, 4, 64, 16, 32), (1, 96, 64, 64, 128, 128),
              (8, 256, 64, 64, 128, 128), (8, 256, 16, 64, 128, 128),
              (8, 256, 8, 64, 16, 32), (8, 256, 4, 64, 16, 32)]
# the SSD backward kernel (phase 7) at phase 12's training shapes: 8 x 256
# tokens through the server (64 heads) and the towers (16), the reduced
# config's server and towers (Q 32, N 16; phase 12 (a)), one chunk per
# sequence (S = Q), a last head group partly filled (201 heads: HG 2 on
# 132 SMs) and P 32; each gradient within 1e-4 of the plain one's largest
# entry (3xTF32 against PyTorch's f32 products, summed in other orders)
SSD_BWD_SHAPES = [(8, 256, 64, 64, 128, 128), (8, 256, 16, 64, 128, 128),
                  (8, 256, 8, 64, 16, 32), (8, 256, 4, 64, 16, 32),
                  (8, 128, 64, 64, 128, 128), (1, 128, 201, 32, 128, 128),
                  (2, 256, 24, 32, 128, 128)]
SSD_BWD_REL = 1e-4
SSD_BWD_NEG_A = -80.0  # a per step: exp above the diagonal would overflow
# the ssm training slice (phase 12): mamba2-1.3b's cut stack at 8 x 256
# tokens, where its merges run the reduce kernels both ways
SSM_TRAIN_SHAPE = (4, 2048, 2048)
SSM_TRAIN_TIME_SHAPES = [("avg", SSM_TRAIN_SHAPE)]
# timed: the server shape at 8192 and 32768 tokens, the tower's at 32768
SSD_TIME_SHAPES = [(1, 8192, 64, 64, 128, 128), (1, 32768, 64, 64, 128, 128),
                   (1, 32768, 16, 64, 128, 128)]
# the ssm slice: (batch, tokens) per forward; the repo's prefill_32k shape
# at batch 1 (its batch of 32 would need 211 GB of f32 logits)
SSM_FORWARDS = [(1, 2048), (1, 8192), (1, 32768), (4, 2048)]
SSM_LOGIT_TOL = 1e-3
SSM_TAIL = 1024  # positions compared at 32768 (the logits are 6.6 GB)
GEN_PROMPTS, GEN_NEW = (4, 256), 16
# the starcoder2-3b slice: long-prompt split serving at full width, two
# decode slots; the plain run covers the prompts up to 8192 tokens (at
# 32768 the plain attention alone would take tens of seconds: phase 5
# holds the kernel at that shape instead)
SC_ARCH = "starcoder2-3b"
SC_PROMPTS = [2500, 8192, 32768, 1024]
SC_NEW = [8, 8, 4, 8]
SC_MAX_BATCH = 2
SC_PLAIN_MAX = 8192
# the paper MLP slice: the paper tables' loop (AdamW 3e-3, batch 256, 400
# steps) on the three datasets at their published widths; the Executor
# run on PhraseBank (plain SGD at 0.1 in the towers and the server)
MLP_MERGES = ("max", "avg", "concat", "mul", "sum")
MLP_LR, MLP_BATCH, MLP_STEPS, MLP_CHECK_STEPS = 3e-3, 256, 400, 5
MLP_DROPS, MLP_TEST_DROP_SEEDS = (1, 2, 3), 4
EXEC_LR, EXEC_STEPS, EXEC_SHORT = 0.1, 200, 20
# the cut stacks: PhraseBank (K 4, cut 64) at batch 256 and at its
# microbatches-4 run's 64 rows, where phase 10 launches the kernels; Bank
# Marketing and Give Me Some Credit (K 2, cut 16) at batch 256, which no
# path launches (their tables' loop merges plainly) but which is checked
# and timed all the same; timed: max at all three, concat at batch 256
MLP_SHAPES = [(4, 256, 64), (4, 64, 64), (2, 256, 16)]
MLP_TIME_SHAPES = [("max", (4, 256, 64)), ("max", (4, 64, 64)),
                   ("max", (2, 256, 16)), ("concat", (4, 256, 64))]
# the no-wait slice (phase 11): smollm-360m's cut stack at batch 8 x 256
# tokens over 4 microbatches, where the imputed merges run the reduce
# kernels both ways; the MLP runs it at phase 10's (4, 64, 64)
NOWAIT_SHAPE = (4, 512, 960)
NOWAIT_TIME_SHAPES = [("avg", NOWAIT_SHAPE)]
NOWAIT_M, NOWAIT_BATCH, NOWAIT_LR = 4, 256, 0.2
NOWAIT_SIM_STEPS, NOWAIT_WALL_STEPS, NOWAIT_LM_STEPS = 40, 20, 5
NOWAIT_SLOWDOWN = 20.0  # the simulated straggler's links and compute
# the wall-clock straggler: 0.06 s per forward against a 0.015 s static
# window, so its m-th cut lands ~4x after role 0's m-th window closes
NOWAIT_DELAY_S, NOWAIT_STATIC_S = 0.06, 0.015
NOWAIT_LM_DELAY_S = 0.1  # smollm's straggler, per forward
# smollm without a straggler: the adaptive window's bootstrap minimum is
# raised from 0.05 s (a 0.025 s floor) to 5 s (a 2.5 s floor), as the CPU
# twin of this run does.  At a step's first microbatch the four feature
# holders regenerate the step's tokens and launch their towers on threads
# that share one interpreter lock, and their cuts can land more than
# 0.025 s apart: a healthy client then misses, and the run checks the
# host's scheduling instead of the no-wait numerics
NOWAIT_LM_BOOTSTRAP_S = 5.0
BF16_TOL, BF16_GAP = 3e-2, 6e-2
# monolithic dense serving (phase 13): 8 x 128-token prompts and one of
# 4096 (past the flash threshold), 32 new tokens each; a ring cache of 256
# slots against a linear one under the same window; int8 KV with 4
# flash-decoding chunks against f32 over 64 decode steps (the JAX
# package's bounds, tests/test_kv_quant.py); the throughput probe at a
# linear cache of 4096 and at the ring of cfg.sliding_window, which is
# the JAX package's decode_cache_plan for prompts past 65536 tokens
MONO_SHORT, MONO_LONG, MONO_NEW = (8, 128), 4096, 32
MONO_RING_BATCH, MONO_RING_PROMPT, MONO_RING = 4, 128, 256
MONO_INT8_BATCH, MONO_INT8_STEPS, MONO_INT8_CHUNKS = 4, 64, 4
MONO_INT8_REL, MONO_INT8_AGREE = 0.02, 0.9
MONO_PROBE_BATCHES, MONO_PROBE_LEN, MONO_PROBE_STEPS = (1, 8, 32), 4096, 16
MONO_RING_PROBE_BATCH = 8
# the training launcher (phase 14): 3 steps for the card-vs-card and the
# monolithic runs, the launcher's own subprocess at 8 x 256; its files go
# under build/ (ignored by git) and are deleted after
LAUNCH_STEPS = 3
LAUNCH_DIR = ROOT / "build" / "chip_smoke"
LAUNCH_TIMEOUT_S = 420
SAME_TOL = 1e-6
# the wire overlays (phase 15): K = 4 towers; the top-level stack of the
# fanout-2 tree at 8 x 256 tokens (client 0 relays for clients 2 and 3)
OVERLAY_K, OVERLAY_STEPS, TOPK_FRACTION = 4, 3, 0.25
OVERLAYS = {
    "topk": (dict(compression="topk", topk_fraction=TOPK_FRACTION), None),
    "int8": (dict(compression="int8"), None),
    "secure": (dict(secure_aggregation=True), None),
    "tree": ({}, 2),
    "secure+tree": (dict(secure_aggregation=True), 2),
}
TREE_SHAPE = (2, 2048, 960)
TREE_TIME_SHAPES = [("sum", TREE_SHAPE)]
MASKED_TOL = 1e-3  # the JAX package's masked-merge verification tolerance
# figures of earlier phases that phases 14 and 15 print their own beside
MEASURED: dict = {}


def log(*parts) -> None:
    print(*parts, flush=True)


def reset_launches() -> None:
    mp.reset_launches()
    fa.reset_launches()
    ssd.reset_launches()


def read_launches() -> dict:
    """Every kernel's count, and the flash kernel's again by head dim (one
    instantiation each), as ``flash_attention_kernel[D=d]``."""
    return {**mp.launches, **fa.launches,
            **{flash_name(d): n for d, n in fa.launches_by_head_dim.items()},
            **ssd.launches}


def flash_name(head_dim: int) -> str:
    return f"flash_attention_kernel[D={head_dim}]"


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


MERGE_CUDA_KERNELS = ("merge_reduce_kernel", "merge_concat_kernel",
                      "merge_reduce_bwd_kernel", "merge_concat_bwd_kernel")
# one instantiation per dtype, strategy and client count: summarised only
MANY_INSTANTIATIONS = ("merge_reduce_kernel", "merge_reduce_bwd_kernel")


def build_library() -> None:
    """Build (nvcc, sm_90a) and load the CUDA C++ library before any
    launch; print the time and the merge kernels' ptxas reports, and fail
    if one of them spills."""
    t0 = time.perf_counter()
    fa.build.library()
    log(f"kernels: CUDA C++ library built and loaded in "
        f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a, "
        f"{', '.join(p.name for p in fa.build.sources())})")
    for kernel in MERGE_CUDA_KERNELS:
        log(f"kernels: {kernel} ptxas: {ptxas_summary(kernel)}")
        if kernel not in MANY_INSTANTIATIONS:
            log(f"kernels: {kernel} ptxas: {ptxas_report(kernel)}")
        counts = _ptxas_counts(kernel)
        if not counts or any(spill for _, spill in counts.values()):
            raise AssertionError(f"{kernel}: no ptxas report, or a spill: "
                                 f"{counts}")


def check_kernels() -> dict:
    """Every strategy x dtype x live mask x shape: kernel vs plain.
    Returns the largest f32 |error| per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"merge_reduce_kernel": 0.0, "merge_concat_kernel": 0.0}
    shapes = [(3, 37, 100), (5, 100, 384)] + PATH_SHAPES + MLP_SHAPES + \
        [NOWAIT_SHAPE, SSM_TRAIN_SHAPE, TREE_SHAPE]
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
                    if strategy == "concat":
                        expect_identical(name, got, want)
                    else:
                        torch.testing.assert_close(
                            got.float(), want.float(), rtol=TOL[dtype],
                            atol=TOL[dtype])
                    if dtype == torch.float32:
                        err = float((got - want).abs().max())
                        worst[name] = max(worst[name], err)
                    n += 1
    log(f"kernels: {n} cases match the plain version "
        f"(f32 tol 1e-5, bf16 tol 2e-2; concat bit-identical); worst f32 "
        f"|err| {worst}")
    return worst


def expect_identical(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """The same shape, dtype and values; NaN where ``want`` has NaN."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan) or \
            not torch.equal(got[~nan], want[~nan]):
        raise AssertionError(f"{name}: not identical to the plain version")


def check_concat_edges() -> int:
    """Both concat kernels on their scalar path and with non-finite values
    in a dropped client, against the plain versions, bit for bit.  Returns
    the number of cases."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in CONCAT_EDGE_SHAPES:
            K, B, D = shape
            n = K * B * D
            fx = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
            fg = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
            # start 1: a contiguous view off the vector boundary
            for start in (0, 1):
                x = fx[start:start + n].view(shape)
                g = fg[start:start + n].view(B, K * D)
                for kind in ("all", "dropped", "none"):
                    live = _live(K, kind, "cuda")
                    expect_identical("merge_concat_kernel",
                                     mp.merge_pool(x, live, strategy="concat"),
                                     ref.merge_pool(x, "concat", live))
                    expect_identical("merge_concat_bwd_kernel",
                                     mp.concat_bwd(live, g, k=K),
                                     ref.concat_bwd(live, g, K))
                    n_cases += 2
            # a NaN and an Inf in the dropped client's slice: NaN out
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn((B, K * D), generator=gen, device="cuda").to(dtype)
            live = _live(K, "dropped", "cuda")
            k = int(torch.nonzero(live == 0)[0])
            x[k, 0, 0], x[k, B - 1, D - 1] = float("nan"), float("inf")
            g[0, k * D], g[B - 1, (k + 1) * D - 1] = float("nan"), float("-inf")
            for name, got, want in (
                    ("merge_concat_kernel",
                     mp.merge_pool(x, live, strategy="concat"),
                     ref.merge_pool(x, "concat", live)),
                    ("merge_concat_bwd_kernel", mp.concat_bwd(live, g, k=K),
                     ref.concat_bwd(live, g, K))):
                if int(torch.isnan(want).sum()) != 2:
                    raise AssertionError(f"{name}: the plain version gave "
                                         "no NaN for a dropped NaN and Inf")
                expect_identical(name, got, want)
                n_cases += 1
    torch.cuda.synchronize()
    log(f"kernels: concat edges: {n_cases} cases bit-identical to the plain "
        f"versions (shapes {CONCAT_EDGE_SHAPES}, f32 and bf16, at storage "
        "offsets 0 and 1, NaN and Inf in a dropped client giving NaN)")
    return n_cases


def check_backward_kernels() -> dict:
    """Every strategy x dtype x live mask x shape: the backward kernels
    against the plain backward, plus mul at an exact zero and max with
    exact ties.  The concat backward and the reductions' sum, avg and max
    must be bit-identical; mul is held at ``GRAD_TOL`` and its identical
    cases are counted.  The zero and the ties are set at the training
    path's shape and at each MLP shape.  Returns the largest f32 |error|
    per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = {"merge_reduce_bwd_kernel": 0.0, "merge_concat_bwd_kernel": 0.0}
    shapes = [(3, 37, 100), (5, 100, 384), (4, 1, 960), TRAIN_SHAPE] + \
        MLP_SHAPES + [NOWAIT_SHAPE, SSM_TRAIN_SHAPE, TREE_SHAPE]
    n = 0
    mul_identical = [0, 0]  # identical, all

    def compare(name, got, want, dtype):
        nonlocal n
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                                 f"{tuple(want.shape)} {want.dtype}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite gradient")
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=GRAD_TOL[dtype], atol=GRAD_TOL[dtype])
        if dtype == torch.float32:
            worst[name] = max(worst[name], float((got - want).abs().max()))
        n += 1

    def reduce_bwd(x, live, out, g, strategy, dtype):
        got = mp.merge_pool_bwd(x, live, out, g, strategy=strategy)
        want = ref.merge_pool_bwd(x, live, out, g, strategy)
        if strategy == "mul":
            mul_identical[0] += int(torch.equal(got, want))
            mul_identical[1] += 1
        else:
            expect_identical("merge_reduce_bwd_kernel", got, want)
        compare("merge_reduce_bwd_kernel", got, want, dtype)

    for strategy in STRATEGIES:
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("all", "dropped", "none"):
                for shape in shapes + ([CONCAT_TRAIN_SHAPE]
                                       if strategy == "concat" else []):
                    x = torch.randn(shape, generator=gen, device="cuda"
                                    ).to(dtype)
                    live = _live(shape[0], kind, "cuda")
                    out = mp.merge_pool(x, live, strategy=strategy)
                    g = torch.randn(out.shape, generator=gen, device="cuda"
                                    ).to(dtype)
                    if strategy == "concat":
                        got = mp.concat_bwd(live, g, k=shape[0])
                        want = ref.concat_bwd(live, g, shape[0])
                        expect_identical("merge_concat_bwd_kernel", got,
                                         want)
                        compare("merge_concat_bwd_kernel", got, want, dtype)
                    else:
                        reduce_bwd(x, live, out, g, strategy, dtype)

    # mul at an exact zero of a live client; max with the last client
    # tied to the first on half the elements
    for shape in [TRAIN_SHAPE] + MLP_SHAPES:
        K, B, D = shape
        x = torch.randn(shape, generator=gen, device="cuda")
        x[1, 7, :100] = 0.0
        x[K - 1] = torch.where(torch.rand(x[0].shape, generator=gen,
                                          device="cuda") < 0.5, x[0], x[K - 1])
        live = _live(K, "all", "cuda")
        g = torch.randn((B, D), generator=gen, device="cuda")
        for strategy in ("mul", "max"):
            out = mp.merge_pool(x, live, strategy=strategy)
            reduce_bwd(x, live, out, g, strategy, torch.float32)
    log(f"backward kernels: {n} cases match the plain backward (f32 tol "
        f"1e-5, bf16 tol 5e-2; concat, and the reductions' sum, avg and "
        f"max, bit-identical; mul bit-identical in {mul_identical[0]} of "
        f"{mul_identical[1]} cases; mul at an exact zero, max with ties); "
        f"worst f32 |err| {worst}")
    return worst


def check_reduce_bwd_edges() -> int:
    """The reductions' backward on its scalar and runtime-K paths, with
    operands at storage offset 1, every live mask, and non-finite values,
    against the plain backward: sum, avg and max bit for bit, mul within
    ``GRAD_TOL``.  A NaN and an Inf in a dropped client reach no gradient
    of max or mul; a NaN in g gives NaN where the plain sum and avg give
    it.  Returns the number of cases."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n_cases = 0

    def check(x, live, out, g, strategy, dtype, finite=False):
        nonlocal n_cases
        got = mp.merge_pool_bwd(x, live, out, g, strategy=strategy)
        want = ref.merge_pool_bwd(x, live, out, g, strategy)
        torch.cuda.synchronize()
        if finite and not (torch.isfinite(got).all()
                           and torch.isfinite(want).all()):
            raise AssertionError(f"merge_reduce_bwd_kernel {strategy}: a "
                                 "dropped NaN or Inf reached a gradient")
        if strategy == "mul":
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError("merge_reduce_bwd_kernel mul: shape or "
                                     "dtype")
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=GRAD_TOL[dtype],
                                       atol=GRAD_TOL[dtype], equal_nan=True)
        else:
            expect_identical("merge_reduce_bwd_kernel", got, want)
        n_cases += 1

    for dtype in (torch.float32, torch.bfloat16):
        for shape in REDUCE_BWD_EDGE_SHAPES:
            K, B, D = shape
            n = K * B * D
            fx = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
            fg = torch.randn(B * D + 1, generator=gen, device="cuda").to(dtype)
            fo = torch.empty(B * D + 1, device="cuda", dtype=dtype)
            # start 1: contiguous views off the vector boundary
            for start in (0, 1):
                x = fx[start:start + n].view(shape)
                g = fg[start:start + B * D].view(B, D)
                out = fo[start:start + B * D].view(B, D)
                for kind in ("all", "dropped", "none"):
                    live = _live(K, kind, "cuda")
                    for strategy in ("sum", "avg", "max", "mul"):
                        out.copy_(mp.merge_pool(x, live, strategy=strategy))
                        check(x, live, out, g, strategy, dtype)
            if K == 1:
                continue
            # a NaN and an Inf in the dropped client's plane
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn((B, D), generator=gen, device="cuda").to(dtype)
            live = _live(K, "dropped", "cuda")
            k = int(torch.nonzero(live == 0)[0])
            x[k, 0, 0], x[k, B - 1, D - 1] = float("nan"), float("inf")
            for strategy in ("max", "mul"):
                check(x, live, mp.merge_pool(x, live, strategy=strategy), g,
                      strategy, dtype, finite=True)
            g[0, 0] = float("nan")
            for strategy in ("sum", "avg"):
                check(None, live, None, g, strategy, dtype)
    log(f"kernels: reduction backward edges: {n_cases} cases (shapes "
        f"{REDUCE_BWD_EDGE_SHAPES}, f32 and bf16, at storage offsets 0 and "
        "1, every live mask; sum, avg and max bit-identical, mul within "
        "1e-5 / 5e-2; a dropped NaN and Inf reach no max or mul gradient, "
        "a NaN in g gives NaN where the plain sum and avg do)")
    return n_cases


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


def bwd_bound(shape, strategy: str, itemsize: int = 4) -> tuple[float, str]:
    """Least time on an H100 SXM for one backward call: each input read
    once, each output written once (sum/avg: g in, dx out; concat: g in,
    dx out; max: stack, out and g in; mul: stack and g in), over the
    memory rate, vs the flops (a few per element) over the f32 rate."""
    K, B, D = shape
    g = B * D * (K if strategy == "concat" else 1)
    reads = {"sum": g, "avg": g, "concat": g, "max": K * B * D + 2 * B * D,
             "mul": K * B * D + B * D}[strategy]
    nbytes = (reads + K * B * D) * itemsize + K * 4
    flops = {"sum": K * B * D, "avg": K * B * D, "concat": K * B * D,
             "max": 4 * K * B * D, "mul": K * (K + 1) * B * D}[strategy]
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_backward_shapes(card: str) -> dict:
    """Backward times at the training paths' shapes (all clients live, as
    trained): the kernel, the plain backward, one PyTorch call where there
    is one, the bound.  max and mul are timed at the avg shape too, for
    the record.  Rows are keyed (kernel, strategy, shape)."""
    rows = {}
    for strategy, shape in [("avg", TRAIN_SHAPE),
                            ("concat", CONCAT_TRAIN_SHAPE),
                            ("max", TRAIN_SHAPE),
                            ("mul", TRAIN_SHAPE)] + MLP_TIME_SHAPES + \
            NOWAIT_TIME_SHAPES + SSM_TRAIN_TIME_SHAPES + TREE_TIME_SHAPES:
        K, B, D = shape
        name = ("merge_concat_bwd_kernel" if strategy == "concat"
                else "merge_reduce_bwd_kernel")
        n_buf = min(16, max(1, math.ceil(2 * L2_BYTES / (K * B * D * 4))))
        live = torch.ones(K, dtype=torch.float32, device="cuda")
        inputs = []
        for _ in range(n_buf):
            x = torch.randn(shape, device="cuda")
            out = mp.merge_pool(x, live, strategy=strategy)
            inputs.append((x, out, torch.randn(out.shape, device="cuda")))
        if strategy == "concat":
            fns = {"": lambda x, o, g: mp.concat_bwd(live, g, k=K),
                   "plain_": lambda x, o, g: ref.concat_bwd(live, g, K),
                   "library_": lambda x, o, g: concat_bwd_library(live, g, K)}
        else:
            fns = {"": lambda x, o, g: mp.merge_pool_bwd(
                       x, live, o, g, strategy=strategy),
                   "plain_": lambda x, o, g: ref.merge_pool_bwd(
                       x, live, o, g, strategy)}
            if strategy == "avg":
                # one call; the two-call form PRs 12-18 timed is kept beside
                # it, labelled, so that their figures stay comparable
                w = avg_weights(live)
                fns["library_"] = lambda x, o, g: w[:, None, None] * g
                fns["library_two_call_"] = lambda x, o, g: (
                    live / float(K))[:, None, None] * g
            if strategy == "sum":  # dx_k = g * l_k, one broadcast multiply
                fns["library_"] = lambda x, o, g: live[:, None, None] * g
        row = {}
        for prefix, fn in fns.items():
            row[prefix + "ms"] = time_ms(fn, inputs)
            row[prefix + "device_ms"] = device_ms(fn, inputs)
        row["bound_ms"], row["bound_by"] = bwd_bound(shape, strategy)
        rows[(name, strategy, shape)] = row
        lib = (f"library {row['library_ms']:.6f} "
               f"({row['library_device_ms']:.6f}) ms, "
               if "library_ms" in row else "")
        if "library_two_call_ms" in row:
            lib += (f"library as two calls (PRs 12-18) "
                    f"{row['library_two_call_ms']:.6f} "
                    f"({row['library_two_call_device_ms']:.6f}) ms, ")
        log(f"time backward {strategy} f32 {shape}: per call (device, launch "
            f"cost removed): kernel {row['ms']:.6f} ({row['device_ms']:.6f}) "
            f"ms, plain {row['plain_ms']:.6f} ({row['plain_device_ms']:.6f}) "
            f"ms, {lib}bound {row['bound_ms']:.6f} ms ({row['bound_by']}) "
            f"| {card}")
        del inputs
    return rows


def host_breakdown(shape, kind: str) -> dict:
    """A merge wrapper's host time per call in microseconds (host clock);
    ``kind`` is the kernel's name.  Measured: the public wrapper
    (``wrapper``); the same wrapper with its C entry point replaced by a
    Python stub that launches nothing (``stubbed``); the output's
    allocation; the current-stream query; the bare ctypes call with
    B = 0 or n = 0, which the C entry point refuses before any CUDA call
    (``ctypes_only``: the Python and ctypes share of a call); and the
    library call of ``time_path_shapes`` / ``time_backward_shapes``
    (reductions: avg).  Derived: ``call_and_launch`` = wrapper - stubbed,
    ``validation`` = stubbed - allocation - stream (the checks and the
    wrapper's own Python).  Each part runs ``HOST_ROUNDS`` rounds of
    ``HOST_CALLS`` calls, the parts taking turns; the median round is
    reported.  The launch counts are restored afterwards: none of these
    calls is a launch of the main path."""
    K, B, D = shape
    x = torch.randn(shape, device="cuda")
    live = torch.ones(K, dtype=torch.float32, device="cuda")
    dev = x.get_device()
    avg, f32 = mp.STRATEGY_CODES["avg"], mp.DTYPE_CODES[torch.float32]
    if kind == "merge_concat_bwd_kernel":
        g = torch.randn((B, K * D), device="cuda")
        name = "repro_merge_concat_bwd"
        dst = torch.empty(shape, device="cuda")
        args = (live.data_ptr(), g.data_ptr(), dst.data_ptr(), 0, D, K, f32,
                dev)
        wrapper = lambda: mp.concat_bwd(live, g, k=K)
        parts = {"allocation": lambda: g.new_empty((K, B, D)),
                 "library": lambda: concat_bwd_library(live, g, K)}
    elif kind == "merge_concat_kernel":
        name = "repro_merge_concat"
        dst = torch.empty((B, K * D), device="cuda")
        args = (x.data_ptr(), live.data_ptr(), dst.data_ptr(), 0, D, K, f32,
                dev)
        wrapper = lambda: mp.merge_pool(x, live, strategy="concat")
        parts = {"allocation": lambda: x.new_empty((B, K * D)),
                 "library": lambda: library_call("concat")(x)}
    elif kind == "merge_reduce_bwd_kernel":
        g = torch.randn((B, D), device="cuda")
        w = avg_weights(live)
        name = "repro_merge_reduce_bwd"
        dst = torch.empty(shape, device="cuda")
        args = (g.data_ptr(), live.data_ptr(), None, None, dst.data_ptr(), 0,
                K, avg, f32, dev)
        wrapper = lambda: mp.merge_pool_bwd(None, live, None, g,
                                            strategy="avg")
        parts = {"allocation": lambda: g.new_empty((K, B, D)),
                 "library": lambda: w[:, None, None] * g}
    else:
        name = "repro_merge_reduce"
        dst = torch.empty((B, D), device="cuda")
        args = (x.data_ptr(), live.data_ptr(), dst.data_ptr(), 0, K, avg, f32,
                dev)
        wrapper = lambda: mp.merge_pool(x, live, strategy="avg")
        parts = {"allocation": lambda: x.new_empty((B, D)),
                 "library": lambda: library_call("avg")(x)}
    entry, real_entry = fa.build.entry(name), fa.build.entry
    stub = lambda *_: 0
    parts.update(wrapper=wrapper, stubbed=wrapper,
                 stream=lambda: fa.build.current_stream(dev),
                 ctypes_only=lambda: entry(*args,
                                           fa.build.current_stream(dev)))
    if parts["ctypes_only"]() == 0:
        raise AssertionError(f"{name} took an empty run")
    counts = dict(mp.launches)
    rounds = {part: [] for part in parts}

    def run(part: str, fn, calls: int) -> None:
        if part == "stubbed":
            fa.build.entry = lambda _: stub
        try:
            for _ in range(calls):
                fn()
        finally:
            fa.build.entry = real_entry

    for part, fn in parts.items():
        run(part, fn, 50)
    for _ in range(HOST_ROUNDS):
        for part, fn in parts.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(part, fn, HOST_CALLS)
            rounds[part].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
    torch.cuda.synchronize()
    mp.launches.update(counts)
    us = {part: sorted(t)[len(t) // 2] for part, t in rounds.items()}
    us["call_and_launch"] = us["wrapper"] - us["stubbed"]
    us["validation"] = us["stubbed"] - us["allocation"] - us["stream"]
    return us


#: the timed rows (kernel, strategy, shape) whose wrapper host time is split
HOST_ROWS = (("merge_reduce_kernel", "avg", (4, 1024, 960)),
             ("merge_concat_kernel", "concat", (4, 1024, 240)),
             ("merge_reduce_bwd_kernel", "avg", TRAIN_SHAPE),
             ("merge_concat_bwd_kernel", "concat", CONCAT_TRAIN_SHAPE))


def time_merge_host(rows: dict, card: str) -> None:
    """Add each merge kernel's wrapper host breakdown to its timed row,
    and print it."""
    for name, strategy, shape in HOST_ROWS:
        row = rows[(name, strategy, shape)]
        row["host_us"] = host_breakdown(shape, name)
        host = ", ".join(f"{part} {t:.2f}"
                         for part, t in row["host_us"].items())
        log(f"time {name} f32 {shape}: host us per call: {host}; per call "
            f"{row['ms']:.6f} ms vs library {row['library_ms']:.6f} ms | "
            f"{card}")


def avg_weights(live: torch.Tensor) -> torch.Tensor:
    """The avg backward's per-client weights ``l_k / max(sum(live), 1)``,
    formed once outside a timed loop: the library call is then one
    broadcast multiply."""
    return live / live.sum().clamp(min=1)


def concat_bwd_library(live: torch.Tensor, g: torch.Tensor, K: int):
    """One PyTorch call computing the concat backward: a permuted view of
    ``g`` times the live flags."""
    B = g.shape[0]
    return g.view(B, K, -1).permute(1, 0, 2) * live[:, None, None]


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
    """Forward times at the serving path's and the MLP path's shapes (all
    clients live, as served and trained).  Rows are keyed (kernel,
    strategy, shape)."""
    rows = {}
    pairs = [("avg", s) for s in PATH_SHAPES] + \
        [("concat", s) for s in CONCAT_PATH_SHAPES] + MLP_TIME_SHAPES + \
        NOWAIT_TIME_SHAPES + SSM_TRAIN_TIME_SHAPES + TREE_TIME_SHAPES
    for strategy, shape in pairs:
        concat = strategy == "concat"
        name = "merge_concat_kernel" if concat else "merge_reduce_kernel"
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
        if concat:  # one copy, where torch.cat first unbinds the stack
            fns["library_reshape_"] = lambda x, lv: x.transpose(
                0, 1).reshape(x.shape[1], -1)
        row = {}
        for prefix, fn in fns.items():
            row[prefix + "ms"] = time_ms(fn, kern)
            row[prefix + "device_ms"] = device_ms(fn, kern)
        row["bound_ms"], row["bound_by"] = bound(shape, 4, concat)
        rows[(name, strategy, shape)] = row
        reshape = (f"transpose-reshape {row['library_reshape_ms']:.6f} "
                   f"({row['library_reshape_device_ms']:.6f}) ms, "
                   if concat else "")
        log(f"time {strategy} f32 {shape}: per call (device, launch cost "
            f"removed): kernel {row['ms']:.6f} ({row['device_ms']:.6f}) "
            f"ms, plain {row['plain_ms']:.6f} "
            f"({row['plain_device_ms']:.6f}) ms, library "
            f"{row['library_ms']:.6f} ({row['library_device_ms']:.6f}) "
            f"ms, {reshape}bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}) | {card}")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------

def make_server(cfg, params, device, use_kernel: bool = True, **kw):
    """A server and its K tower workers; ``use_kernel=False`` sends the
    merge and the long-prompt attention of role 0 and of every tower to
    the plain versions."""
    program = split_program.get_program(cfg)
    _, server = program.partition(params)
    workers = [build_split_worker(k, cfg=cfg, params=params, device=device,
                                  use_kernel=use_kernel)
               for k in range(cfg.vertical.num_clients)]
    return SplitLMServer(SimTransport(workers), cfg, server, device=device,
                         use_kernel=use_kernel, **kw)


def serve(cfg, params, prompts, new_tokens, **kw):
    """One serving run on a fresh server; returns (tokens, stats, seconds,
    launches during the run)."""
    srv = make_server(cfg, params, "cuda", **kw)
    for p, n in zip(prompts, new_tokens):
        srv.submit(p, max_new_tokens=n)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = srv.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
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
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
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

    # warm-up: cuBLAS initializes (not measured)
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

    MEASURED["serve"] = dict(tokens=tokens, seconds=t_main)
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


# ---------------------------------------------------------------------------
# phase 4: the training slice
# ---------------------------------------------------------------------------

def train(cfg, steps: int, device: str, params=None, **kw):
    """One ``train_split`` run; returns (out, metrics, seconds, launches
    during the run, peak device memory)."""
    loader = LMBatchLoader(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    kw.setdefault("print_fn", log)
    out, metrics, _ = train_split(
        cfg, loader, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        runtime="serial", learning_rate=3e-4, warmup=20, seed=SEED,
        log_every=1, device=device, params=params, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if not all(math.isfinite(x) for x in metrics.losses):
        raise AssertionError(f"non-finite loss: {metrics.losses}")
    return out, metrics, seconds, launches, peak


def expect_launches(launches: dict, want: dict) -> None:
    full = {name: want.get(name, 0) for name in launches}
    if launches != full:
        raise AssertionError(f"launches {launches}, expected {full}")


def train_small_against_cpu() -> None:
    """Reduced smollm-360m, same weights: 2 steps on the card (kernels)
    against 2 steps on the CPU (plain versions) — losses and final params
    within 1e-4."""
    cfg = get_arch("smollm-360m").reduced()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    cpu_params = backbone.init_params(cfg, gen, device="cpu")
    runs = {}
    for device, params in (("cpu", cpu_params),
                           ("cuda", _to(cpu_params, "cuda"))):
        out, metrics, _, launches, _ = train(cfg, 2, device, params=params)
        runs[device] = (out, metrics.losses)
    expect_launches(launches, {"merge_reduce_kernel": 2,
                               "merge_reduce_bwd_kernel": 2})
    torch.testing.assert_close(torch.tensor(runs["cuda"][1]),
                               torch.tensor(runs["cpu"][1]), rtol=1e-4,
                               atol=1e-4)
    worst = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        _leaves(runs["cuda"][0]), _leaves(runs["cpu"][0])))
    if worst > 1e-4:
        raise AssertionError(f"reduced model: card params differ from the "
                             f"CPU path by {worst:.3e} > 1e-4")
    log(f"small train: reduced smollm-360m, 2 steps on the card match the CPU "
        f"path (losses {runs['cuda'][1]} vs {runs['cpu'][1]}; final params "
        f"max |diff| {worst:.3e} <= 1e-4)")


def train_full(card: str) -> dict:
    cfg = get_arch("smollm-360m")
    # warm-up: one step compiles nothing new for the kernels (phase 2 built
    # them at these shapes) but starts cuBLAS's backward paths
    train(cfg, 1, "cuda", verify_step0=False)
    _, metrics, seconds, launches, peak = train(cfg, TRAIN_STEPS, "cuda")
    expect_launches(launches, {"merge_reduce_kernel": TRAIN_STEPS,
                               "merge_reduce_bwd_kernel": TRAIN_STEPS})
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = metrics.step_times[1:]
    log(f"train avg: {TRAIN_STEPS} steps of {tokens} tokens, losses "
        f"{metrics.losses}, step-0 max |dgrad| vs protocol_step "
        f"{metrics.step0_max_dgrad:.3e} (<= 1e-5); "
        f"{launches['merge_reduce_kernel']} merge_reduce_kernel and "
        f"{launches['merge_reduce_bwd_kernel']} merge_reduce_bwd_kernel "
        f"launches | {card}")
    MEASURED["inproc_train_tokens_s"] = len(steady) * tokens / sum(steady)
    log(f"train avg: {len(steady) * tokens / sum(steady):.1f} train tokens/s "
        f"over steps 1-{TRAIN_STEPS - 1} (step times {metrics.step_times} "
        f"s; step 0 includes the verification), wall {seconds:.4f} s with "
        f"set-up, max_memory_allocated {peak} bytes | {card}")

    ccfg = cfg.with_vertical(dataclasses.replace(cfg.vertical,
                                                 merge="concat"))
    _, cmetrics, cseconds, claunches, _ = train(ccfg, 2, "cuda")
    expect_launches(claunches, {"merge_concat_kernel": 2,
                                "merge_concat_bwd_kernel": 2})
    log(f"train concat: 2 steps, losses {cmetrics.losses}, step-0 max "
        f"|dgrad| {cmetrics.step0_max_dgrad:.3e}, "
        f"{claunches['merge_concat_kernel']} merge_concat_kernel and "
        f"{claunches['merge_concat_bwd_kernel']} merge_concat_bwd_kernel "
        f"launches, wall {cseconds:.4f} s | {card}")
    return {"merge_reduce_bwd_kernel": launches["merge_reduce_bwd_kernel"],
            "merge_concat_bwd_kernel": claunches["merge_concat_bwd_kernel"]}


# ---------------------------------------------------------------------------
# phase 5: the flash-attention kernel against the plain version
# ---------------------------------------------------------------------------

def _flash_inputs(shape, dtype, gen, model_layout: bool):
    """q (B, H, S, D), k and v (B, Hkv, S, D); in the model's layout they
    are transposed views of (B, S, H, D) tensors, as attention_apply
    passes them."""
    B, H, Hkv, S, D = shape
    if model_layout:
        return [torch.randn((B, S, h, D), generator=gen, device="cuda"
                            ).to(dtype).transpose(1, 2) for h in (H, Hkv, Hkv)]
    return [torch.randn((B, h, S, D), generator=gen, device="cuda").to(dtype)
            for h in (H, Hkv, Hkv)]


def check_flash_kernel() -> dict:
    """Path and ragged shapes x causal/full x f32/bf16: kernel vs plain.
    Returns the largest f32 |error| per head dim."""
    log(f"flash: ptxas: {ptxas_report('flash_attention_kernel')}")
    spills = {inst: spill for inst, (_, spill) in
              _ptxas_counts("flash_attention_kernel").items() if spill}
    if spills:
        raise AssertionError(f"flash kernel spills registers: {spills}")
    counts = tensor_core_instructions("flash_attention_kernel")
    if counts is None:
        log("flash: SASS not read: no cuobjdump in the CUDA toolkit or in "
            "Triton's package")
    else:
        log(f"flash: tensor-core instructions (HMMA / HGMMA) in the SASS "
            f"of each instantiation: {counts}")
        if not counts or not all(counts.values()):
            raise AssertionError(f"flash kernel without tensor-core "
                                 f"instructions: {counts}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst, n = dict.fromkeys(fa.HEAD_DIMS, 0.0), 0
    model_layout = FLASH_PATH_SHAPES + FLASH_WIDE_SHAPES
    for shape in FLASH_SMALL_SHAPES + model_layout:
        for causal in (True, False) if shape[3] <= 8192 else (True,):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = _flash_inputs(shape, dtype, gen,
                                        shape in model_layout)
                got = fa.flash_attention(q, k, v, causal=causal)
                want = ref.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != dtype:
                    raise AssertionError(f"flash {shape}: {tuple(got.shape)} "
                                         f"{got.dtype}")
                if not torch.isfinite(got).all():
                    raise AssertionError(f"flash {shape}: non-finite output")
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=FLASH_TOL[dtype],
                                           atol=FLASH_TOL[dtype])
                if dtype == torch.float32:
                    worst[shape[4]] = max(worst[shape[4]],
                                          float((got - want).abs().max()))
                n += 1
                del q, k, v, got, want
    torch.cuda.empty_cache()
    log(f"flash kernel: {n} cases match the plain version (f32 tol 5e-4, "
        f"bf16 tol 3e-2; (B, H, Hkv, S, D) in {FLASH_SMALL_SHAPES}, "
        f"{FLASH_PATH_SHAPES} and {FLASH_WIDE_SHAPES}, causal and full up "
        f"to 8192 tokens); worst f32 |err| by head dim "
        + ", ".join(f"D {d}: {e:.3e}" for d, e in worst.items()))
    return worst


def cuobjdump() -> str | None:
    """The toolkit's cuobjdump, or the copy in Triton's package."""
    import shutil

    found = shutil.which("cuobjdump")
    candidates = [Path(found)] if found else []
    candidates.append(Path("/usr/local/cuda/bin/cuobjdump"))
    try:
        import triton

        candidates.append(Path(triton.__file__).parent / "backends" /
                          "nvidia" / "bin" / "cuobjdump")
    except ImportError:
        pass
    return next((str(c) for c in candidates if c.is_file()), None)


def tensor_core_instructions(kernel: str) -> dict | None:
    """HMMA / HGMMA instructions in the SASS of each instantiation of
    ``kernel`` in the built library (None without a cuobjdump)."""
    tool = cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(fa.build.library_path())],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[-1].strip()
            current = name if kernel in name else None
            if current:
                counts[current] = 0
        elif current and re.search(r"\bH(G)?MMA\b", line):
            counts[current] += 1
    return counts


def flash_bound(B, H, Hkv, S, D, itemsize=4, causal=True) -> tuple:
    """Least time on an H100 SXM for the kernel's f32-accurate work: two
    D-deep products per attended (q, kv) pair, each as three TF32 products
    (3xTF32) at the tensor cores' dense TF32 rate, vs q, k, v read once and
    o written once.  Also returns the f32-FMA figure (the same products at
    the f32 rate outside the tensor cores) and the f32 flops."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * D * B * H * pairs
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * itemsize
    t_ops, t_bytes = 3 * flops / H100_TF32_FLOPS, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            max(flops / H100_F32_FLOPS, t_bytes) * 1e3, flops)


def time_flash(card: str) -> dict:
    """Every shape of FLASH_TIME_SHAPES, causal f32, in the model's layout:
    the kernel, the plain version, one library call and the bound, by
    shape.  The library call is scaled_dot_product_attention's
    memory-efficient backend on kv heads repeated before the call: this
    PyTorch's fused f32 backends refuse enable_gqa=True, and its math
    backend would hold the 64 GB score matrix at 32768.  At the 8192-token
    smollm-360m shape the enable_gqa=True call (the math backend) is timed
    too, for the record."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention

    rows = {}
    for shape in FLASH_TIME_SHAPES:
        B, H, Hkv, S, D = shape
        gen = torch.Generator(device="cuda").manual_seed(S + D)
        q, k, v = _flash_inputs(shape, torch.float32, gen, True)
        kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))

        def library():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return scaled_dot_product_attention(q, kr, vr, is_causal=True)

        fns = {"": lambda: fa.flash_attention(q, k, v, causal=True),
               "plain_": lambda: ref.flash_attention(q, k, v, causal=True),
               "library_": library}
        big = S > 8192
        if shape == FLASH_TIME_SHAPES[0]:
            fns["library_gqa_"] = lambda: scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        row = {}
        for prefix, fn in fns.items():
            slow = big and prefix == "plain_"
            row[prefix + "ms"] = time_ms(
                lambda _: fn(), [(None,)], iters=2 if slow else
                (5 if big else 20))
            row[prefix + "device_ms"] = device_ms(
                lambda _: fn(), [(None,)], iters=1 if slow else
                (3 if big else 10), reps=2 if slow else 3)
        row["bound_ms"], row["bound_by"], row["fma_bound_ms"], flops = \
            flash_bound(*shape)
        got, want = fns[""](), fns["library_"]()
        torch.cuda.synchronize()
        row["library_max_abs_diff"] = float((got - want).abs().max())
        rows[shape] = row
        log(f"time flash causal f32 ({B}, {H}/{Hkv}, {S}, {D}): per call "
            f"(device): kernel {row['ms']:.6f} ({row['device_ms']:.6f}) ms = "
            f"{flops / row['device_ms'] / 1e9:.2f} f32 TFLOP/s "
            f"({100 * row['bound_ms'] / row['device_ms']:.1f}% of the "
            f"3xTF32 tensor-core bound, "
            f"{100 * row['fma_bound_ms'] / row['device_ms']:.1f}% of the "
            f"f32-FMA bound), plain "
            f"{row['plain_ms']:.6f} ({row['plain_device_ms']:.6f}) ms, "
            f"library {row['library_ms']:.6f} ({row['library_device_ms']:.6f})"
            f" ms (max |kernel - library| {row['library_max_abs_diff']:.3e}),"
            + (f" library enable_gqa=True {row['library_gqa_ms']:.6f} "
               f"({row['library_gqa_device_ms']:.6f}) ms,"
               if "library_gqa_ms" in row else "")
            + f" bound {row['bound_ms']:.6f} ms ({row['bound_by']}, 3xTF32 at "
            f"495 TFLOP/s), fma_bound {row['fma_bound_ms']:.6f} ms (f32 at "
            f"67 TFLOP/s) | {card}")
        del q, k, v, kr, vr, got, want
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 6: long-prompt split serving
# ---------------------------------------------------------------------------

def serve_recording(cfg, params, prompts, new_tokens, *, use_kernel=True,
                    **kw):
    """``serve`` that also keeps each request's prefill logits (requests
    are admitted in submission order) and the server's wire report."""
    srv = make_server(cfg, params, "cuda", use_kernel=use_kernel, **kw)
    logits = []
    prefill = srv._fns.prefill

    def recording_prefill(*args):
        out, cache = prefill(*args)
        logits.append(out[0].detach().clone())
        return out, cache

    srv._fns.prefill = recording_prefill
    for p, n in zip(prompts, new_tokens):
        srv.submit(p, max_new_tokens=n)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = srv.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if [len(r.tokens) for r in results] != list(new_tokens):
        raise AssertionError("long serving: a request did not complete")
    return ([r.tokens for r in results], dict(srv.stats), seconds, launches,
            logits, srv.wire_report(), dict(srv.cut_cache.stats))


def serve_long(card: str) -> int:
    cfg = get_arch("smollm-360m")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = backbone.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, s) for s in LONG_PROMPTS]
    cache_len = max(s + n for s, n in zip(LONG_PROMPTS, LONG_NEW))
    kw = dict(cache_len=cache_len, max_batch=4,
              cut_cache_bytes=LONG_CUT_CACHE_BYTES)
    K = cfg.vertical.num_clients
    per_prompt = (cfg.num_layers - cfg.vertical.tower_layers
                  + K * cfg.vertical.tower_layers)
    n_long = sum(s * s > attn_lib.FLASH_THRESHOLD ** 2 for s in LONG_PROMPTS)
    log(f"long serving: {cfg.name} full width, K={K}, prompts {LONG_PROMPTS}, "
        f"new tokens {LONG_NEW}, cache_len {cache_len}, cut cache "
        f"{LONG_CUT_CACHE_BYTES} bytes (largest cut "
        f"{max(LONG_PROMPTS) * cfg.d_model * 4} bytes)")

    serve(cfg, params, prompts[:1], [2], **kw)  # warm-up (not measured)

    # prefill only, one request at a time: time to the first token
    srv = make_server(cfg, params, "cuda", **kw)
    prefill_s = []
    for p in prompts:
        srv.submit(p, max_new_tokens=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.run()
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    del srv
    log("long prefill (max_new_tokens=1, one request at a time): " + ", ".join(
        f"{s} tokens {s / t:.1f} tok/s ({t:.4f} s)"
        for s, t in zip(LONG_PROMPTS, prefill_s)) + f" | {card}")
    # the whole batch, prefill only: what the full run spends before decode
    _, _, t_prefill, _ = serve(cfg, params, prompts, [1] * len(prompts), **kw)

    # the main path: counters reset just before the run, read just after
    torch.cuda.reset_peak_memory_stats()
    tokens, stats, t_main, launches, logits, wire, cut_stats = \
        serve_recording(cfg, params, prompts, LONG_NEW, **kw)
    peak = torch.cuda.max_memory_allocated()
    if stats["reprefills"]:
        raise AssertionError(f"long serving re-prefilled: {stats}")
    merges = stats["prefills"] + sum(n - 1 for n in LONG_NEW)
    expect_launches(launches, {"flash_attention_kernel": per_prompt * n_long,
                               flash_name(64): per_prompt * n_long,
                               "merge_reduce_kernel": merges})
    pf = [costs.serve_prefill_bytes(s, cfg.d_model, K)["total"]
          for s in LONG_PROMPTS]
    dc = costs.serve_decode_bytes(cfg.d_model, K, rounds=sum(LONG_NEW)
                                  - len(LONG_NEW))["total"]
    if wire["total"] != sum(pf) + dc:
        raise AssertionError(f"ledger {wire['total']} bytes != cost model "
                             f"{sum(pf) + dc}")

    # the plain run: merge and attention on the plain versions everywhere
    ptokens, _, t_plain, plaunch, plogits, _, _ = serve_recording(
        cfg, params, prompts, LONG_NEW, use_kernel=False, **kw)
    if any(plaunch.values()):
        raise AssertionError(f"the plain run launched kernels: {plaunch}")
    diffs = [float((a - b).abs().max()) for a, b in zip(logits, plogits)]
    gaps = [float(torch.topk(x, 2).values[0] - torch.topk(x, 2).values[1])
            for x in plogits]
    log(f"long serving: prefill logits kernel vs plain, max |diff| per "
        f"request {diffs} (tol 1e-3); top-2 logit gap of the plain run "
        f"{gaps}")
    if len(logits) != len(LONG_PROMPTS) or max(diffs) > 1e-3:
        raise AssertionError(f"prefill logits differ: {diffs}")
    if not all(torch.isfinite(x).all() for x in logits):
        raise AssertionError("non-finite prefill logits")
    if ptokens != tokens:
        raise AssertionError(f"the plain run gave other tokens: {tokens} vs "
                             f"{ptokens}")

    decode_tokens = sum(LONG_NEW) - len(LONG_NEW)
    t_decode = t_main - t_prefill
    log(f"long serving continuous: {len(prompts)} requests, "
        f"{stats['tokens']} tokens, {stats['decode_rounds']} decode rounds, "
        f"{launches['flash_attention_kernel']} flash_attention_kernel "
        f"launches ({per_prompt} per prompt past 2048 tokens x {n_long}), "
        f"{launches['merge_reduce_kernel']} merge_reduce_kernel launches "
        f"({merges} merges); cut cache {cut_stats}; ledger {wire['total']} "
        f"bytes = cost model | {card}")
    log(f"long serving: wall {t_main:.4f} s (plain run {t_plain:.4f} s); "
        f"prefill-only run of the batch {t_prefill:.4f} s "
        f"({sum(LONG_PROMPTS) / t_prefill:.1f} tok/s); decode "
        f"{decode_tokens / t_decode:.1f} tok/s ({decode_tokens} tokens in the "
        f"{t_decode:.4f} s the full run took beyond it); "
        f"max_memory_allocated {peak} bytes; tokens identical to the plain "
        f"run | {card}")
    return launches["flash_attention_kernel"]


def check_small_long_against_cpu(arch: str = "smollm-360m",
                                 head_dim: int = 0) -> None:
    """Reduced ``arch`` (at ``head_dim`` where it is given: ``reduced()``
    resets it), one 2304-token prompt: the card (flash kernel and merge
    kernel) against the CPU path (chunked plain attention) — prefill
    logits within 1e-4, identical greedy tokens."""
    cfg = get_arch(arch).reduced()
    if head_dim:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    cpu_params = backbone.init_params(cfg, gen, device="cpu")
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab_size, 2304)
    cache_len = 2304 + 8
    out = {}
    for device, params in (("cpu", cpu_params), ("cuda", _to(cpu_params,
                                                              "cuda"))):
        reset_launches()
        srv = make_server(cfg, params, device, cache_len=cache_len)
        cut = srv.driver.prefill(0, torch.as_tensor(prompt, device=device),
                                 cache_len)
        logits, _ = srv._fns.prefill(srv.server_params,
                                     srv._fns.init_cache(cache_len,
                                                         device=device), cut)
        srv.submit(prompt, max_new_tokens=8)
        out[device] = (logits.cpu(), [r.tokens for r in srv.run()],
                       read_launches())
    per_prefill = (cfg.num_layers - cfg.vertical.tower_layers
                   + cfg.vertical.num_clients * cfg.vertical.tower_layers)
    d = cfg.resolved_head_dim()
    if out["cuda"][2]["flash_attention_kernel"] != 2 * per_prefill or \
            out["cuda"][2][flash_name(d)] != 2 * per_prefill or any(
            out["cpu"][2].values()):
        raise AssertionError(f"reduced long prompt launches: card "
                             f"{out['cuda'][2]}, CPU {out['cpu'][2]}")
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    if out["cuda"][1] != out["cpu"][1]:
        raise AssertionError("reduced long prompt: card tokens differ from "
                             "CPU")
    log(f"small long: reduced {arch} (head dim {d}), a 2304-token prompt "
        f"on the card "
        f"matches the CPU path (prefill logits max |diff| "
        f"{float((out['cuda'][0] - out['cpu'][0]).abs().max()):.3e} <= "
        f"1e-4, identical greedy tokens, {2 * per_prefill} flash launches)")


# ---------------------------------------------------------------------------
# phase 7: the SSD chunk kernel against the plain version
# ---------------------------------------------------------------------------

def _ssd_inputs(shape, gen):
    """The JAX package's test distributions (``tests/test_kernels.py``);
    B and C as the model passes them, strided views of the conv output
    ``[x, B, C]`` with one group."""
    B, S, H, P, N, _ = shape
    x = torch.randn((B, S, H, P), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda") * 0.5)
    A = -torch.exp(torch.randn((H,), generator=gen, device="cuda") * 0.3)
    u = torch.randn((B, S, H * P + 2 * N), generator=gen, device="cuda") * 0.3
    Bm = u[..., H * P:H * P + N].reshape(B, S, 1, N)
    Cm = u[..., H * P + N:].reshape(B, S, 1, N)
    return x, dt, A, Bm, Cm


def _ptxas_counts(kernel: str) -> dict:
    """{instantiation: (registers, spill bytes stored and loaded)} for
    ``kernel`` from the build log; an instantiation is named by its element
    type (where it has one) and its integer template arguments, read from
    the mangled name."""
    counts, current = {}, ""
    for line in fa.build.library_path().with_suffix(".log").read_text(
            ).splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            current = line
        elif kernel in current and ("registers" in line or "spill" in line):
            args = re.findall(r"Li(\d+)E", current)
            if "nv_bfloat16" in current:
                args.insert(0, "bf16")
            elif f"{kernel}If" in current:
                args.insert(0, "f32")
            inst = f"<{', '.join(args)}>"
            regs, spill = counts.get(inst, (0, 0))
            counts[inst] = (
                regs + sum(map(int, re.findall(r"Used (\d+) registers", line))),
                spill + sum(map(int, re.findall(r"(\d+) bytes spill", line))))
    return counts


def ptxas_report(kernel: str) -> str:
    """ptxas's registers and spills for each instantiation of ``kernel``,
    from the build log."""
    return "; ".join(f"{inst} {regs} registers, {spill} bytes of spill"
                     for inst, (regs, spill) in _ptxas_counts(kernel).items())


def ptxas_summary(kernel: str) -> str:
    """The range of registers and the total spill bytes over every
    instantiation of ``kernel`` (the merge kernel has one per dtype,
    strategy and client count)."""
    counts = _ptxas_counts(kernel).values()
    regs = [r for r, _ in counts]
    return (f"{len(regs)} instantiations, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers, "
            f"{sum(s for _, s in counts)} bytes of spill in all")


def check_ssd_kernel() -> float:
    """Every phase-7 shape: the kernel against ref.ssd_chunks, and
    ops.ssd_scan against the model's ssd_chunked, on the card.  Returns
    the largest |error| of the kernel's outputs."""
    log(f"ssd: ptxas: {ptxas_report('ssd_chunk_kernel')}")
    notes = {}
    for line in fa.build.library_path().with_suffix(".log").read_text(
            ).splitlines():
        code = re.search(r"\((C75\d\d)\)", line)
        if code and "ssd_chunk" in line:
            notes[code[1]] = notes.get(code[1], 0) + 1
    log(f"ssd: ptxas notes on wgmma by code (C7515 and C7520: the wgmmas "
        f"are serialized; C7519: an injected warpgroup.arrive): {notes}")
    if notes.get("C7515") or notes.get("C7520"):
        raise AssertionError(f"ssd kernel: ptxas serialized its wgmmas: "
                             f"{notes}")
    spills = {inst: spill for inst, (_, spill) in
              _ptxas_counts("ssd_chunk_kernel").items() if spill}
    if spills:
        raise AssertionError(f"ssd kernel spills registers: {spills}")
    counts = tensor_core_instructions("ssd_chunk_kernel")
    if counts is None:
        log("ssd: SASS not read: no cuobjdump in the CUDA toolkit or in "
            "Triton's package")
    else:
        log(f"ssd: tensor-core instructions (HMMA / HGMMA) in the SASS of "
            f"each instantiation: {counts}")
        if not counts or not all(counts.values()):
            raise AssertionError(f"ssd kernel without tensor-core "
                                 f"instructions: {counts}")
    cfg = get_arch("mamba2-1.3b")
    heads = cfg.ssm.n_heads(cfg.d_model)
    plans = {(B, S, h): ssd.plan(B, S, h, cfg.ssm.head_dim,
                                 cfg.ssm.d_state, cfg.ssm.chunk_size,
                                 torch.device("cuda", 0))
             for B, S in SSM_FORWARDS
             for h in (heads, heads // cfg.vertical.num_clients)}
    log("ssd: heads per block (HG) and blocks at phase 8's shapes (B, S, "
        "heads): " + "; ".join(f"{k}: HG {v['heads']}, {v['blocks']} blocks"
                               for k, v in plans.items()))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst, worst_scan = 0.0, 0.0
    for shape in SSD_SHAPES:
        x, dt, A, Bm, Cm = _ssd_inputs(shape, gen)
        chunk = min(shape[-1], shape[1])
        a, xdt = dt * A, x * dt[..., None]
        got = ssd.ssd_chunk(xdt, a, Bm[:, :, 0], Cm[:, :, 0], chunk)
        want = ref.ssd_chunks(xdt, a, Bm[:, :, 0], Cm[:, :, 0], chunk)
        torch.cuda.synchronize()
        for name, g, w in zip(("y_intra", "state", "decay", "cum"), got,
                              want):
            if g.shape != w.shape or not torch.isfinite(g).all():
                raise AssertionError(f"ssd {shape} {name}: "
                                     f"{tuple(g.shape)}, finite "
                                     f"{bool(torch.isfinite(g).all())}")
            torch.testing.assert_close(g, w, rtol=SSD_TOL, atol=SSD_TOL)
            worst = max(worst, float((g - w).abs().max()))
        del got, want
        state = torch.randn(shape[0], shape[2], shape[3], shape[4],
                            generator=gen, device="cuda") * 0.1
        y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, shape[-1],
                              initial_state=state)
        wy, wfin = mamba.ssd_chunked(x, dt, A, Bm, Cm, shape[-1],
                                     initial_state=state)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, wy, rtol=SSD_TOL, atol=SSD_TOL)
        torch.testing.assert_close(fin, wfin, rtol=SSD_TOL, atol=SSD_TOL)
        worst_scan = max(worst_scan, float((y - wy).abs().max()),
                         float((fin - wfin).abs().max()))
    grad_worst = check_ssd_scan_grads(gen)
    log(f"ssd kernel: {len(SSD_SHAPES)} shapes (B, S, H, P, N, chunk) "
        f"{SSD_SHAPES} match ref.ssd_chunks (tol 3e-4; worst |err| "
        f"{worst:.3e}); ops.ssd_scan matches ssd_chunked on the card (worst "
        f"|err| {worst_scan:.3e}); under autograd its gradients (both SSD "
        f"kernels) match autograd of ssd_chunked within 3e-4 of each "
        f"gradient's largest entry (worst {grad_worst:.3e} of it)")
    return worst


def check_ssd_scan_grads(gen) -> float:
    """ops.ssd_scan under autograd on the card (the forward and backward
    kernels through ops.SSDChunk) against autograd of the model's own
    ssd_chunked, from a nonzero state, at the reduced config's and the
    server's shapes: every input's gradient within 3e-4 (the forward
    kernel's tolerance: the recurrence's gradients read its 3xTF32 states)
    of its largest entry.  Returns the worst error over that entry."""
    worst = 0.0
    for shape in [(2, 256, 8, 64, 16, 32), (2, 2048, 64, 64, 128, 128)]:
        x, dt, A, Bm, Cm = _ssd_inputs(shape, gen)
        B, _, H, P, N, chunk = shape
        state = torch.randn((B, H, P, N), generator=gen, device="cuda") * 0.1
        inputs = [x, dt, A, Bm, Cm, state]
        gy, gfin = torch.randn_like(x), torch.randn_like(state)
        runs = []
        for fn in (ops.ssd_scan, mamba.ssd_chunked):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in inputs]
            before = ssd.launches["ssd_chunk_bwd_kernel"]
            y, fin = fn(*leaves[:5], chunk, initial_state=leaves[5])
            runs.append(torch.autograd.grad(
                (y * gy).sum() + (fin * gfin).sum(), leaves))
            launched = ssd.launches["ssd_chunk_bwd_kernel"] - before
            if launched != (fn is ops.ssd_scan):
                raise AssertionError(f"ssd grads {shape}: {fn.__name__} "
                                     f"launched the backward {launched}x")
        for name, g, w in zip(("x", "dt", "A", "B", "C", "state"), *runs):
            scale = float(w.abs().max())
            err = float((g - w).abs().max()) / scale
            if not torch.isfinite(g).all() or err > SSD_TOL:
                raise AssertionError(f"ssd grads {shape} d{name}: |err| "
                                     f"{err:.3e} of its largest entry")
            worst = max(worst, err)
    return worst


def ssd_bwd_bound(B, S, H, P, N, Q) -> tuple:
    """Least time on an H100 SXM for one backward call: its operations as
    three TF32 products each (3xTF32) at the tensor cores' dense TF32
    rate, vs its bytes.  The operations the function needs: per (batch, chunk) C B^T over the
    causal half (Q(Q+1)/2 pairs, 2N each; B and C are shared by the
    heads) and dC, dB as (sum over heads of dM o L) times B and C (2N per
    pair each); per (batch, chunk, head) dM = gy x^T and M^T gy over the
    causal half (2P per pair each), L, M, dM o L, R and its sums (6 per
    pair), B gS^T and (x o w) gS (2QPN each), and the w-terms of dx and T
    (4QP).  Bytes: xdt, a, B, C, gy, gstate, gcum read once, dx, da, dB,
    dC written once.  Returns the bound, what bounds it, the f32-FMA
    figure (the same flops at the f32 rate outside the tensor cores, vs
    the bytes) and the f32 flops."""
    nc = S // Q
    pairs = Q * (Q + 1) // 2
    flops = B * nc * (3 * pairs * 2 * N + H * (
        pairs * (4 * P + 6) + 4 * Q * P * N + 4 * Q * P))
    nbytes = 4 * (3 * B * S * H * P + B * nc * H * P * N + 3 * B * S * H
                  + 4 * B * S * N)
    t_ops, t_bytes = 3 * flops / H100_TF32_FLOPS, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            max(flops / H100_F32_FLOPS, t_bytes) * 1e3, flops)


def _ssd_bwd_inputs(shape, gen, upstream=(True, True, True)):
    """The backward's arguments at ``shape``: the forward's inputs (xdt, a,
    B and C as the model passes them) and random upstream gradients of
    y_intra, the states and cum, None where ``upstream`` says absent."""
    x, dt, A, Bm, Cm = _ssd_inputs(shape, gen)
    B, S, H, P, N, Q = shape
    ups = (torch.randn((B, S, H, P), generator=gen, device="cuda"),
           torch.randn((B, S // Q, H, P, N), generator=gen, device="cuda"),
           torch.randn((B, S, H), generator=gen, device="cuda"))
    return [x * dt[..., None], dt * A, Bm[:, :, 0], Cm[:, :, 0]] + [
        u if on else None for u, on in zip(ups, upstream)] + [Q]


def _bwd_error(shape, what, got, want) -> float:
    """The largest |kernel - plain| over each gradient's largest plain
    entry; raises past SSD_BWD_REL or on a non-finite value."""
    worst = 0.0
    for name, g, w in zip(("dx", "da", "dB", "dC"), got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"ssd bwd {shape} {what} {name}: "
                                 f"{tuple(g.shape)}, finite "
                                 f"{bool(torch.isfinite(g).all())}")
        scale = float(w.abs().max())
        err = float((g - w).abs().max()) / scale if scale else \
            float(g.abs().max())
        if err > SSD_BWD_REL:
            raise AssertionError(f"ssd bwd {shape} {what} {name}: |kernel - "
                                 f"plain| {err:.3e} of its largest entry > "
                                 f"{SSD_BWD_REL}")
        worst = max(worst, err)
    return worst


def check_ssd_bwd_kernel() -> float:
    """The backward kernel against ref.ssd_chunks_bwd at every
    SSD_BWD_SHAPES shape with every upstream gradient, at the server shape
    with each upstream alone and with very negative a; two launches
    bit-identical.  Returns the worst |error| over each gradient's largest
    plain entry.  Fails first on a spill, a ptxas note that the wgmmas
    are serialized, or an instantiation without HGMMA in its SASS."""
    log(f"ssd bwd: ptxas: {ptxas_report('ssd_chunk_bwd_kernel')}; reduce "
        f"pass: {ptxas_report('ssd_chunk_bwd_reduce_kernel')}")
    notes = {}
    for line in fa.build.library_path().with_suffix(".log").read_text(
            ).splitlines():
        code = re.search(r"\((C75\d\d)\)", line)
        if code and "ssd_chunk_bwd" in line:
            notes[code[1]] = notes.get(code[1], 0) + 1
    log(f"ssd bwd: ptxas notes on wgmma by code (C7511, C7512, C7515 and "
        f"C7520: the wgmmas are serialized): {notes}")
    if any(notes.get(code) for code in ("C7511", "C7512", "C7515", "C7520")):
        raise AssertionError(f"ssd bwd kernel: ptxas serialized its "
                             f"wgmmas: {notes}")
    spills = {inst: spill for inst, (_, spill) in
              _ptxas_counts("ssd_chunk_bwd_kernel").items() if spill}
    if spills:
        raise AssertionError(f"ssd bwd kernel spills registers: {spills}")
    counts = tensor_core_instructions("ssd_chunk_bwd_kernel")
    if counts is None:
        log("ssd bwd: SASS not read: no cuobjdump in the CUDA toolkit or in "
            "Triton's package")
    else:
        log(f"ssd bwd: tensor-core instructions (HMMA / HGMMA) in the SASS "
            f"of each instantiation: {counts}")
        if not counts or not all(counts.values()):
            raise AssertionError(f"ssd bwd kernel without tensor-core "
                                 f"instructions: {counts}")
    plans = {shape: ssd.bwd_plan(*shape, torch.device("cuda", 0))
             for shape in SSD_BWD_SHAPES}
    log("ssd bwd: heads per block (HG), groups and blocks at each shape (B, "
        "S, H, P, N, chunk): " + "; ".join(
            f"{k}: HG {v['heads']}, {v['groups']} groups, {v['blocks']} "
            f"blocks" for k, v in plans.items()))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst, n = 0.0, 0
    alone = {"gy": (True, False, False), "gstate": (False, True, False),
             "gcum": (False, False, True)}
    for shape in SSD_BWD_SHAPES:
        cases = {"all": (True, True, True)}
        if shape == SSD_BWD_SHAPES[0]:
            cases.update(alone)
        for what, upstream in cases.items():
            args = _ssd_bwd_inputs(shape, gen, upstream)
            got = ssd.ssd_chunk_bwd(*args)
            want = ref.ssd_chunks_bwd(*args)
            torch.cuda.synchronize()
            worst = max(worst, _bwd_error(shape, what, got, want))
            n += 1
    shape = SSD_BWD_SHAPES[0]
    args = _ssd_bwd_inputs(shape, gen)
    args[1] = torch.full_like(args[1], SSD_BWD_NEG_A)
    worst = max(worst, _bwd_error(shape, f"a = {SSD_BWD_NEG_A}",
                                  ssd.ssd_chunk_bwd(*args),
                                  ref.ssd_chunks_bwd(*args)))
    args = _ssd_bwd_inputs(shape, gen)
    first, second = ssd.ssd_chunk_bwd(*args), ssd.ssd_chunk_bwd(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "da", "dB", "dC"), first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"ssd bwd {shape}: two launches differ in "
                                 f"{name}")
    log(f"ssd bwd kernel: {n} cases (B, S, H, P, N, chunk) over "
        f"{SSD_BWD_SHAPES} (every upstream gradient; at the first shape "
        f"also each alone) and a = {SSD_BWD_NEG_A} per step there match "
        f"ref.ssd_chunks_bwd within {SSD_BWD_REL} of each gradient's "
        f"largest entry (worst {worst:.3e} of it), all finite; two "
        f"launches bit-identical")
    return worst


def time_ssd_bwd(card: str) -> dict:
    """The backward kernel at phase 12's server and tower shapes: per call
    and on the device, the plain backward likewise, and the bound (3xTF32
    vs bytes, with the f32-FMA figure beside it).  No single PyTorch call
    computes this gradient (autograd of the plain forward is a dozen
    calls), so there is no library time."""
    rows = {}
    for shape in SSD_BWD_SHAPES[:2]:
        gen = torch.Generator(device="cuda").manual_seed(shape[2])
        args = _ssd_bwd_inputs(shape, gen)
        fns = {"": lambda: ssd.ssd_chunk_bwd(*args),
               "plain_": lambda: ref.ssd_chunks_bwd(*args)}
        row = {"max_abs_err": max(float((g - w).abs().max()) for g, w in zip(
            fns[""](), fns["plain_"]()))}
        for prefix, fn in fns.items():
            row[prefix + "ms"] = time_ms(lambda _: fn(), [(None,)], iters=20)
            row[prefix + "device_ms"] = device_ms(lambda _: fn(), [(None,)],
                                                  iters=10, reps=3)
        row["bound_ms"], row["bound_by"], row["fma_ms"], flops = \
            ssd_bwd_bound(*shape)
        rows[shape] = row
        B, S, H = shape[:3]
        log(f"time ssd bwd f32 ({B}, {S}, {H} heads, P 64, N 128, Q 128): "
            f"kernel vs plain max |err| {row['max_abs_err']:.3e}; per call "
            f"(device): kernel {row['ms']:.6f} ({row['device_ms']:.6f}) ms "
            f"= {flops / row['device_ms'] / 1e9:.2f} f32 TFLOP/s of the "
            f"function's {flops / 1e9:.3f} GFLOP "
            f"({100 * row['bound_ms'] / row['device_ms']:.1f}% of the "
            f"bound), plain {row['plain_ms']:.6f} "
            f"({row['plain_device_ms']:.6f}) ms, library none (no single "
            f"PyTorch call computes it), bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}; 3xTF32 at 495 TFLOP/s vs 3.35 TB/s), "
            f"f32-FMA figure {row['fma_ms']:.6f} ms (67 TFLOP/s) | {card}")
        del args, fns
        torch.cuda.empty_cache()
    return rows


def ssd_bound(B, S, H, P, N, Q) -> tuple:
    """Least time on an H100 SXM for one kernel call: per (batch, chunk)
    the causal half of C B^T (Q(Q+1)/2 pairs, 2N flops each; one group,
    so the heads share it); per (chunk, head) its decay scaling and the y
    product (2P + 2 per pair), the x scaling and the state (QP + 2QPN),
    as three TF32 products each (3xTF32) at the tensor cores' dense TF32
    rate; vs xdt, a, B, C read once and y_intra, state, decay, cum written
    once.  Returns the bound, what bounds it, the f32-FMA figure (the same
    flops at the f32 rate outside the tensor cores, vs the bytes) and the
    f32 flops."""
    nc = S // Q
    pairs = Q * (Q + 1) // 2
    flops = B * nc * (pairs * 2 * N + H * (
        pairs * (2 * P + 2) + Q * P + 2 * Q * P * N))
    nbytes = 4 * (2 * B * S * H * P + 2 * B * S * H + 2 * B * S * N
                  + B * nc * H * (P * N + 1))
    t_ops, t_bytes = 3 * flops / H100_TF32_FLOPS, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            max(flops / H100_F32_FLOPS, t_bytes) * 1e3, flops)


def time_ssd(card: str) -> tuple:
    """Every shape of SSD_TIME_SHAPES: the kernel's outputs against the
    plain version's (ref.ssd_chunks), the kernel per call and on the
    device, the plain version likewise, and the bound.  No single PyTorch
    call computes this function (a masked, decay-weighted quadratic form
    per chunk plus the chunk's state), so there is no library time.
    Returns the rows by shape and the largest |error|."""
    rows, worst = {}, 0.0
    for shape in SSD_TIME_SHAPES:
        S, H = shape[1], shape[2]
        gen = torch.Generator(device="cuda").manual_seed(S + 1)
        x, dt, A, Bm, Cm = _ssd_inputs(shape, gen)
        a, xdt = dt * A, x * dt[..., None]
        b, c = Bm[:, :, 0], Cm[:, :, 0]
        big = S > 8192
        fns = {"": lambda: ssd.ssd_chunk(xdt, a, b, c, 128),
               "plain_": lambda: ref.ssd_chunks(xdt, a, b, c, 128)}
        err = 0.0
        for name, g, w in zip(("y_intra", "state", "decay", "cum"),
                              fns[""](), fns["plain_"]()):
            torch.testing.assert_close(g, w, rtol=SSD_TOL, atol=SSD_TOL,
                                       msg=lambda m: f"ssd {shape} {name}: "
                                       f"{m}")
            err = max(err, float((g - w).abs().max()))
        worst = max(worst, err)
        row = {"max_abs_err": err}
        for prefix, fn in fns.items():
            slow = big and prefix == "plain_"  # ~9 ms a call at 32768
            row[prefix + "ms"] = time_ms(lambda _: fn(), [(None,)],
                                         iters=5 if slow else 20)
            row[prefix + "device_ms"] = device_ms(
                lambda _: fn(), [(None,)], iters=3 if slow else 10, reps=3)
        row["bound_ms"], row["bound_by"], row["fma_bound_ms"], flops = \
            ssd_bound(*shape)
        row["plan"] = ssd.plan(*shape, torch.device("cuda", 0))
        rows[shape] = row
        log(f"time ssd f32 (1, {S}, {H} heads, P 64, N 128, Q 128; HG "
            f"{row['plan']['heads']}, {row['plan']['blocks']} blocks): "
            f"kernel vs plain max |err| {err:.3e} (tol 3e-4); per call "
            f"(device): kernel {row['ms']:.6f} ({row['device_ms']:.6f}) ms = "
            f"{flops / row['device_ms'] / 1e9:.2f} f32 TFLOP/s "
            f"({100 * row['bound_ms'] / row['device_ms']:.1f}% of the "
            f"bound, {100 * row['fma_bound_ms'] / row['device_ms']:.1f}% of "
            f"the f32-FMA figure), plain {row['plain_ms']:.6f} "
            f"({row['plain_device_ms']:.6f}) ms, library none (no single "
            f"PyTorch call computes it), bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}; 3xTF32 at 495 TFLOP/s vs 3.35 TB/s), "
            f"fma_bound {row['fma_bound_ms']:.6f} ms (f32 at 67 TFLOP/s) | "
            f"{card}")
        del x, dt, A, Bm, Cm, a, xdt, b, c
        torch.cuda.empty_cache()
    return rows, worst


# ---------------------------------------------------------------------------
# phase 8: the ssm slice — forward and generate of mamba2-1.3b
# ---------------------------------------------------------------------------

def ssm_forward(cfg, params, tokens, use_kernel: bool = True):
    """One timed forward; returns (logits, seconds, launches, peak)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits, _ = backbone.forward(params, {"tokens": tokens}, cfg,
                                 use_kernel=use_kernel)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return logits, seconds, read_launches(), torch.cuda.max_memory_allocated()


def ssm_per_forward(cfg) -> int:
    v = cfg.vertical
    return cfg.num_layers - v.tower_layers + v.num_clients * v.tower_layers


def replay(cfg, params, tokens, cache_len: int):
    """The prompt replayed through decode_step, as generate runs it: the
    logits at every position (B, S, V) and the cache after the prompt."""
    cache = backbone.init_cache(cfg, tokens.shape[0], cache_len,
                                device=tokens.device)
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = backbone.decode_step(params, cache, tokens[:, t], cfg)
        out.append(logits)
    return torch.stack(out, dim=1), cache


def top2_gap(logits: torch.Tensor) -> float:
    top = torch.topk(logits, 2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).min())


def ssm_full(card: str) -> int:
    cfg = get_arch("mamba2-1.3b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = backbone.init_params(cfg, gen, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    per = ssm_per_forward(cfg)
    v = cfg.vertical
    log(f"ssm model: {cfg.name} full width ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, d_state {cfg.ssm.d_state}, "
        f"{cfg.ssm.n_heads(cfg.d_model)} heads of {cfg.ssm.head_dim}, chunk "
        f"{cfg.ssm.chunk_size}, vocab {cfg.vocab_size}), {n_params} params "
        f"f32, K={v.num_clients} towers of {v.tower_layers} layers (width "
        f"{cfg.d_model // v.num_clients}), merge {v.merge}, "
        f"{cfg.num_layers - v.tower_layers} server layers")
    if n_params != 1_414_019_584:
        raise AssertionError(f"mamba2-1.3b has {n_params} params, expected "
                             "1414019584")
    rng = np.random.default_rng(SEED)
    warm = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 256)),
                           device="cuda")
    for use_kernel in (True, False):  # warm-up (not measured)
        ssm_forward(cfg, params, warm, use_kernel)

    total = 0
    for B, S in SSM_FORWARDS:
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                 device="cuda")
        logits, t_kernel, launches, peak = ssm_forward(cfg, params, tokens)
        expect_launches(launches, {"ssd_chunk_kernel": per})
        total += launches["ssd_chunk_kernel"]
        keep = slice(-SSM_TAIL, None) if S > 8192 else slice(None)
        kept = logits[:, keep].clone()
        del logits
        plain, t_plain, plaunch, ppeak = ssm_forward(cfg, params, tokens,
                                                     use_kernel=False)
        if any(plaunch.values()):
            raise AssertionError(f"the plain forward launched kernels: "
                                 f"{plaunch}")
        pkept = plain[:, keep]
        if not torch.isfinite(kept).all():
            raise AssertionError(f"ssm forward ({B}, {S}): non-finite logits")
        diff = float((kept - pkept).abs().max())
        # the argmax is held only where the plain run's top-2 gap exceeds
        # twice the logit tolerance: a closer tie may flip by rounding
        top = torch.topk(pkept[:, -1], 2, dim=-1).values
        gaps = top[:, 0] - top[:, 1]
        held = gaps > 2 * SSM_LOGIT_TOL
        same = torch.equal(kept[:, -1].argmax(-1)[held],
                           pkept[:, -1].argmax(-1)[held])
        skipped = (~held).nonzero().flatten().tolist()
        where = (f"the last {SSM_TAIL} positions" if S > 8192
                 else "all positions")
        log(f"ssm forward ({B}, {S}): kernel {B * S / t_kernel:.1f} tok/s "
            f"({t_kernel:.4f} s, {launches['ssd_chunk_kernel']} "
            f"ssd_chunk_kernel launches, max_memory_allocated {peak} bytes); "
            f"plain {B * S / t_plain:.1f} tok/s ({t_plain:.4f} s, 0 launches, "
            f"max_memory_allocated {ppeak} bytes); logits max |kernel - "
            f"plain| over {where} {diff:.3e} (tol 1e-3), last-position "
            f"argmax identical {same} (requests whose top-2 gap is at most "
            f"2e-3, not held to it: {skipped}), smallest top-2 gap there "
            f"{float(gaps.min()):.4f} | {card}")
        if diff > SSM_LOGIT_TOL or not same:
            raise AssertionError(f"ssm forward ({B}, {S}): kernel vs plain "
                                 f"logits {diff:.3e}, argmax same {same}")
        del kept, plain, pkept
        torch.cuda.empty_cache()

    # greedy generate: the prompt replayed through the exact recurrence
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, GEN_PROMPTS),
                              device="cuda")
    forward_logits, _, flaunch, _ = ssm_forward(cfg, params, prompts)
    expect_launches(flaunch, {"ssd_chunk_kernel": per})
    generate(params, cfg, prompts[:, :8], max_new_tokens=2)  # warm-up
    B, S = GEN_PROMPTS
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, max_new_tokens=GEN_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    glaunch = read_launches()
    if any(glaunch.values()):
        raise AssertionError(f"generate launched kernels: {glaunch}")
    first = forward_logits[:, -1].argmax(-1)
    if out.shape != (B, GEN_NEW) or not torch.equal(out[:, 0], first):
        raise AssertionError(f"generate: first tokens {out[:, 0].tolist()} "
                             f"!= the forward's argmax {first.tolist()}")
    # the same steps timed apart: the prompt replay, then the decode
    t0 = time.perf_counter()
    replayed, cache = replay(cfg, params, prompts, S + GEN_NEW)
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t0
    tok, steps = replayed[:, -1].argmax(-1), []
    t0 = time.perf_counter()
    for _ in range(GEN_NEW - 1):
        steps.append(tok)
        logits, cache = backbone.decode_step(params, cache, tok, cfg)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    if not torch.equal(torch.stack(steps + [tok], dim=1), out):
        raise AssertionError("generate's tokens differ from its steps run "
                             "one by one")
    rdiff = float((replayed - forward_logits).abs().max())
    decode_tokens = B * (GEN_NEW - 1)
    log(f"ssm generate: {B} prompts of {S} tokens, {GEN_NEW} new tokens "
        f"each, greedy, 0 ssd_chunk_kernel launches, wall {t_gen:.4f} s; "
        f"its steps timed apart: prompt replay {B * S / t_replay:.1f} tok/s "
        f"({S} steps in {t_replay:.4f} s), decode "
        f"{decode_tokens / t_decode:.1f} tok/s ({GEN_NEW - 1} steps in "
        f"{t_decode:.4f} s); first tokens {first.tolist()} = the kernel "
        f"forward's argmax; replayed logits vs forward max |diff| "
        f"{rdiff:.3e}, smallest top-2 gap at the last position "
        f"{top2_gap(forward_logits[:, -1]):.4f}, over all positions "
        f"{top2_gap(forward_logits):.4f} | {card}")
    return total


def check_small_ssm_against_cpu() -> None:
    """Reduced mamba2-1.3b, same weights: the card (SSD kernel) against the
    CPU path (the kernel's plain version) — forward logits within 1e-4 with
    3 launches, identical greedy tokens, and decode replay within the JAX
    package's 2e-3 of the forward."""
    cfg = get_arch("mamba2-1.3b").reduced()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    cpu_params = backbone.init_params(cfg, gen, device="cpu")
    gpu_params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 256)))
    prompts = tokens[:, :64]
    out = {}
    for device, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        reset_launches()
        logits, _ = backbone.forward(params, {"tokens": tokens.to(device)},
                                     cfg)
        launches = read_launches()
        toks = generate(params, cfg, prompts, max_new_tokens=8)
        out[device] = (logits.cpu(), toks.cpu(), launches)
    per = ssm_per_forward(cfg)
    if out["cuda"][2]["ssd_chunk_kernel"] != per or any(
            out["cpu"][2].values()):
        raise AssertionError(f"reduced ssm launches: card {out['cuda'][2]}, "
                             f"CPU {out['cpu'][2]}")
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    if not torch.equal(out["cuda"][1], out["cpu"][1]):
        raise AssertionError("reduced ssm: card tokens differ from the CPU")
    replayed, _ = replay(cfg, gpu_params, prompts.cuda(), prompts.shape[1])
    rdiff = float((replayed.cpu() - out["cuda"][0][:, :64]).abs().max())
    if rdiff > 2e-3:
        raise AssertionError(f"reduced ssm: decode replay vs forward "
                             f"{rdiff:.3e} > 2e-3")
    log(f"small ssm: reduced mamba2-1.3b on the card matches the CPU path "
        f"(forward logits max |diff| "
        f"{float((out['cuda'][0] - out['cpu'][0]).abs().max()):.3e} <= 1e-4, "
        f"{per} ssd_chunk_kernel launches, identical greedy tokens); decode "
        f"replay vs forward {rdiff:.3e} <= 2e-3")


def check_small_ssm_bf16_against_cpu(card: str) -> None:
    """Reduced mamba2-1.3b with a bf16 tree: greedy ``generate`` over its
    f32 decode cache (the path of Queue 3's second fault), the card
    against the CPU from the same weights.  Each row's tokens must be
    equal up to its first step whose top-2 logit gap on the CPU is
    ``BF16_GAP`` or less (past such a near-tie the runs may part)."""
    cfg = get_arch("mamba2-1.3b").reduced()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    cpu_params = backbone.init_params(cfg, gen, device="cpu",
                                      dtype=torch.bfloat16)
    gpu_params = _to(cpu_params, "cuda")
    prompts = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (3, 10)))
    new = 8
    toks = {"cpu": generate(cpu_params, cfg, prompts, max_new_tokens=new),
            "cuda": generate(gpu_params, cfg, prompts.to("cuda"),
                             max_new_tokens=new).cpu()}
    # the CPU's logits at each generated position: its prompt and its
    # own tokens replayed through the decode step
    seq = torch.cat([prompts, toks["cpu"]], dim=1)
    logits, _ = replay(cfg, cpu_params, seq[:, :-1], seq.shape[1])
    top = torch.topk(logits[:, prompts.shape[1] - 1:].float(), 2,
                     dim=-1).values
    gaps = top[..., 0] - top[..., 1]  # (3, new)
    held = 0
    for row in range(3):
        for t in range(new):
            if float(gaps[row, t]) <= BF16_GAP:
                break
            if int(toks["cuda"][row, t]) != int(toks["cpu"][row, t]):
                raise AssertionError(
                    f"bf16 ssm generate: row {row} step {t}: card token "
                    f"{int(toks['cuda'][row, t])} != CPU "
                    f"{int(toks['cpu'][row, t])} at top-2 gap "
                    f"{float(gaps[row, t]):.4f}")
            held += 1
    if not held:
        raise AssertionError(f"bf16 ssm generate: no token held (gaps "
                             f"{gaps.tolist()})")
    log(f"small ssm bf16: reduced mamba2-1.3b, bf16 tree over the f32 "
        f"decode cache, greedy generate of 3 x {new} tokens on the card "
        f"and the CPU: {held} of {3 * new} tokens held equal (each row up "
        f"to its first CPU top-2 gap <= {BF16_GAP}), all equal "
        f"{torch.equal(toks['cuda'], toks['cpu'])}, smallest gap "
        f"{float(gaps.min()):.4f} | {card}")


# ---------------------------------------------------------------------------
# phase 9: long-prompt split serving of starcoder2-3b (head dim 128)
# ---------------------------------------------------------------------------

def sc_serving_kw(cfg) -> dict:
    """The phase's server settings: a cache for the longest request, two
    slots, and room in the cut cache for the largest merged cut in each
    slot (3072 floats a token: 403 MB at 32768 tokens)."""
    return dict(cache_len=max(s + n for s, n in zip(SC_PROMPTS, SC_NEW)),
                max_batch=SC_MAX_BATCH,
                cut_cache_bytes=SC_MAX_BATCH * max(SC_PROMPTS) * cfg.d_model
                * 4)


def serve_starcoder(card: str) -> int:
    """Full-width starcoder2-3b, K = 4, two slots, greedy, prompts of
    SC_PROMPTS tokens: the prefill of each, one request at a time, then
    the whole traffic with the counters reset just before the run and read
    just after (36 flash launches at D = 128 per prompt past 2048 tokens,
    one merge launch per merge, none at another head dim), then the plain
    run of the prompts up to SC_PLAIN_MAX tokens (identical tokens,
    prefill logits within 1e-3).  Returns the flash launches."""
    cfg = get_arch(SC_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    params = backbone.init_params(cfg, gen, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, s) for s in SC_PROMPTS]
    kw = sc_serving_kw(cfg)
    K = cfg.vertical.num_clients
    per_prompt = (cfg.num_layers - cfg.vertical.tower_layers
                  + K * cfg.vertical.tower_layers)
    long = [s * s > attn_lib.FLASH_THRESHOLD ** 2 for s in SC_PROMPTS]
    head_dim = cfg.resolved_head_dim()
    log(f"{SC_ARCH}: full width, {n_params} params ({param_bytes} bytes "
        f"f32), K={K}, head dim {head_dim} (server "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, towers "
        f"{cfg.num_heads // K}/{max(1, cfg.num_kv_heads // K)}), prompts "
        f"{SC_PROMPTS}, new tokens {SC_NEW}, {SC_MAX_BATCH} slots, cache_len "
        f"{kw['cache_len']}, cut cache {kw['cut_cache_bytes']} bytes")

    serve(cfg, params, prompts[:1], [2], **kw)  # warm-up (not measured)

    # prefill only, one request at a time: time to the first token
    srv = make_server(cfg, params, "cuda", **kw)
    prefill_s = []
    for p in prompts:
        srv.submit(p, max_new_tokens=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.run()
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    del srv
    log(f"{SC_ARCH} prefill (max_new_tokens=1, one request at a time): "
        + ", ".join(f"{s} tokens {s / t:.1f} tok/s ({t:.4f} s)"
                    for s, t in zip(SC_PROMPTS, prefill_s)) + f" | {card}")

    # the main path: counters reset just before the run, read just after
    tokens, stats, t_main, launches, logits, wire, cut_stats = \
        serve_recording(cfg, params, prompts, SC_NEW, **kw)
    peak = torch.cuda.max_memory_allocated()
    if stats["reprefills"]:
        raise AssertionError(f"{SC_ARCH} serving re-prefilled: {stats}")
    merges = stats["prefills"] + sum(n - 1 for n in SC_NEW)
    flash = per_prompt * sum(long)
    expect_launches(launches, {"flash_attention_kernel": flash,
                               flash_name(head_dim): flash,
                               "merge_reduce_kernel": merges})
    pf = [costs.serve_prefill_bytes(s, cfg.d_model, K)["total"]
          for s in SC_PROMPTS]
    dc = costs.serve_decode_bytes(cfg.d_model, K, rounds=sum(SC_NEW)
                                  - len(SC_NEW))["total"]
    if wire["total"] != sum(pf) + dc:
        raise AssertionError(f"ledger {wire['total']} bytes != cost model "
                             f"{sum(pf) + dc}")
    if len(logits) != len(SC_PROMPTS) or not all(
            torch.isfinite(x).all() for x in logits):
        raise AssertionError(f"{SC_ARCH}: missing or non-finite prefill "
                             "logits")

    # the plain run of the prompts up to SC_PLAIN_MAX tokens
    small = [i for i, s in enumerate(SC_PROMPTS) if s <= SC_PLAIN_MAX]
    ptokens, _, t_plain, plaunch, plogits, _, _ = serve_recording(
        cfg, params, [prompts[i] for i in small], [SC_NEW[i] for i in small],
        use_kernel=False, **kw)
    if any(plaunch.values()):
        raise AssertionError(f"the plain run launched kernels: {plaunch}")
    diffs = [float((logits[i] - x).abs().max()) for i, x in zip(small,
                                                                plogits)]
    gaps = [float(torch.topk(x, 2).values[0] - torch.topk(x, 2).values[1])
            for x in plogits]
    log(f"{SC_ARCH}: prefill logits kernel vs plain, max |diff| for the "
        f"prompts of {[SC_PROMPTS[i] for i in small]} tokens {diffs} (tol "
        f"1e-3); top-2 logit gap of the plain run {gaps}; logits at "
        f"{[s for s in SC_PROMPTS if s > SC_PLAIN_MAX]} tokens finite")
    if max(diffs) > 1e-3:
        raise AssertionError(f"prefill logits differ: {diffs}")
    if ptokens != [tokens[i] for i in small]:
        raise AssertionError(f"the plain run gave other tokens: "
                             f"{[tokens[i] for i in small]} vs {ptokens}")
    log(f"{SC_ARCH} serving continuous: {len(prompts)} requests, "
        f"{stats['tokens']} tokens, {stats['decode_rounds']} decode rounds, "
        f"{launches['flash_attention_kernel']} flash_attention_kernel "
        f"launches, all at D = {head_dim} ({per_prompt} per prompt past 2048 "
        f"tokens x {sum(long)}), {launches['merge_reduce_kernel']} "
        f"merge_reduce_kernel launches ({merges} merges); cut cache "
        f"{cut_stats}; ledger {wire['total']} bytes = cost model; wall "
        f"{t_main:.4f} s (plain run of {len(small)} requests "
        f"{t_plain:.4f} s); max_memory_allocated {peak} bytes; tokens "
        f"identical to the plain run | {card}")
    del params
    torch.cuda.empty_cache()
    return launches["flash_attention_kernel"]


# ---------------------------------------------------------------------------
# phase 10: the paper's vertically split MLP
# ---------------------------------------------------------------------------

def mlp_metrics(logits_fn, x, y, num_classes, batch=2048) -> tuple:
    """Test accuracy and F1 as the paper's tables compute them: macro-F1,
    or the positive class's F1 for two classes."""
    with torch.no_grad():
        pred = torch.cat([logits_fn(x[i:i + batch]).argmax(-1)
                          for i in range(0, len(x), batch)]).cpu().numpy()
    y = y.cpu().numpy()
    acc = float((pred == y).mean())
    f1s = []
    for c in range(num_classes):
        tp = float(((pred == c) & (y == c)).sum())
        fp = float(((pred == c) & (y != c)).sum())
        fn = float(((pred != c) & (y == c)).sum())
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom else 0.0)
    return acc, f1s[1] if num_classes == 2 else float(np.mean(f1s))


def mlp_train(cfg, ds, params, *, centralized=False, num_drop=0, gen=None,
              masks=None) -> tuple:
    """The paper tables' loop (``paper_tables.train_split`` /
    ``train_centralized``): AdamW(3e-3), batch 256, 400 steps over
    ``minibatches(seed=0)`` of a device-resident split, on the params'
    device.  Drops draw their masks from ``gen``, or take ``masks[i]``.
    Returns (params, losses, seconds)."""
    device = ds.x_train.device
    opt = AdamW(learning_rate=MLP_LR)
    state = opt.init(params)
    if centralized:
        step = split_model.make_centralized_train_step(cfg, opt)
    else:
        step = split_model.make_split_train_step(cfg, opt, num_drop=num_drop)
    losses = []
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = synthetic.minibatches(ds.x_train, ds.y_train, MLP_BATCH, seed=SEED,
                               epochs=1000)
    for i, (xb, yb) in enumerate(it):
        if i >= MLP_STEPS:
            break
        if centralized:
            params, state, loss = step(params, state, xb, yb)
        else:
            params, state, loss = step(
                params, state, gen, xb, yb,
                live_mask=None if masks is None else masks[i])
        losses.append(loss)
    losses = torch.stack(losses).tolist()
    seconds = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{cfg.name}: non-finite loss")
    return params, losses, seconds


def mlp_eval(cfg, ds, params, centralized=False, live_mask=None) -> tuple:
    if centralized:
        fn = lambda x: split_model.centralized_forward(params, x)
    else:
        fn = lambda x: split_model.split_forward(params, x, cfg,
                                                 live_mask=live_mask)
    return mlp_metrics(fn, ds.x_test, ds.y_test, cfg.num_classes)


def mlp_card_and_cpu(label, cfg, dsets, init, card, *, centralized=False,
                     num_drop=0, gen=None, cpu_masks=None):
    """One run on the card and the same run on the card's CPU from the same
    weights: the first MLP_CHECK_STEPS losses must agree within 1e-5.
    Prints both runs' test accuracy and F1 and the card's samples/s.  The
    card's run draws its drop masks from ``gen``; the CPU's takes
    ``cpu_masks``, the same masks.  Returns the card's params."""
    out = {
        "card": mlp_train(cfg, dsets["card"], _to(init, "cuda"),
                          centralized=centralized, num_drop=num_drop,
                          gen=gen),
        "cpu": mlp_train(cfg, dsets["cpu"], init, centralized=centralized,
                         num_drop=num_drop, masks=cpu_masks)}
    diff = max(abs(a - b) for a, b in zip(out["card"][1][:MLP_CHECK_STEPS],
                                          out["cpu"][1][:MLP_CHECK_STEPS]))
    if diff > 1e-5:
        raise AssertionError(f"{label}: the first {MLP_CHECK_STEPS} losses "
                             f"on the card {out['card'][1][:5]} and the CPU "
                             f"{out['cpu'][1][:5]} differ by {diff:.3e}")
    metrics = {d: mlp_eval(cfg, dsets[d], out[d][0], centralized)
               for d in out}
    seconds = out["card"][2]
    log(f"mlp {label}: {MLP_STEPS} steps, {MLP_STEPS * MLP_BATCH / seconds:.1f}"
        f" train samples/s on the card ({seconds:.4f} s; CPU "
        f"{MLP_STEPS * MLP_BATCH / out['cpu'][2]:.1f}), loss "
        f"{out['card'][1][0]:.6f} -> {out['card'][1][-1]:.6f}, first "
        f"{MLP_CHECK_STEPS} losses within {diff:.3e} of the CPU's; test acc "
        f"/ F1 card {metrics['card'][0]:.4f} / {metrics['card'][1]:.4f}, CPU "
        f"{metrics['cpu'][0]:.4f} / {metrics['cpu'][1]:.4f} | {card}")
    return out["card"][0]


def mlp_tables(card: str) -> None:
    """Phase 10, part 1: the paper tables' loop on the card for every
    dataset and merge, the centralized baseline, and PhraseBank's drops.
    It merges with the plain version, as the JAX package's step does, so
    no kernel may launch."""
    reset_launches()
    for name, base in PAPER_DATASETS.items():
        ds = synthetic.make_dataset(name, seed=SEED)
        dsets = {"card": synthetic.to_device(ds, "cuda"),
                 "cpu": synthetic.to_device(ds, "cpu")}
        log(f"mlp {name}: {len(ds.x_train)} train / {len(ds.x_test)} test "
            f"rows x {ds.num_features} features, {ds.num_classes} classes, "
            f"K={base.num_clients} clients {base.client_feature_sizes}, "
            f"towers {base.tower_hidden} -> cut {base.cut_dim}, server "
            f"{base.server_hidden}")
        gen = torch.Generator(device="cpu").manual_seed(SEED)
        init = split_model.init_centralized_mlp(gen, base, device="cpu")
        mlp_card_and_cpu(f"{name} centralized", base, dsets, init, card,
                         centralized=True)
        for merge in MLP_MERGES:
            cfg = dataclasses.replace(base, merge=merge)
            gen = torch.Generator(device="cpu").manual_seed(SEED)
            init = split_model.init_split_mlp(gen, cfg, device="cpu")
            params = mlp_card_and_cpu(f"{name} {merge}", cfg, dsets, init,
                                      card)
            if name != "financial_phrasebank" or merge != "max":
                continue
            # paper Table 4: drops at test time on the clean model ...
            for nd in MLP_DROPS:
                accs = [mlp_eval(cfg, dsets["card"], params, live_mask=(
                    dropping.sample_live_mask(torch.Generator(
                        device="cuda").manual_seed(100 + s),
                        cfg.num_clients, nd)))[0]
                    for s in range(MLP_TEST_DROP_SEEDS)]
                log(f"mlp {name} max: {nd} of {cfg.num_clients} clients "
                    f"dropped at test time: acc {np.mean(accs):.4f} (mean "
                    f"over {MLP_TEST_DROP_SEEDS} masks {accs})")
            # ... and during training: masks drawn on the card, the same
            # masks handed to the CPU run
            for nd in MLP_DROPS:
                twin = torch.Generator(device="cuda").manual_seed(SEED + nd)
                masks = torch.stack([
                    dropping.sample_live_mask(twin, cfg.num_clients, nd)
                    for _ in range(MLP_STEPS)]).cpu()
                mlp_card_and_cpu(
                    f"{name} max, {nd} of {cfg.num_clients} clients dropped "
                    "per step", cfg, dsets, init, card, num_drop=nd,
                    gen=torch.Generator(device="cuda").manual_seed(SEED + nd),
                    cpu_masks=masks)
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the paper tables' loop launched kernels "
                             f"(it merges with the plain version): "
                             f"{launches}")
    log("mlp tables: no kernel launched (the one-program step merges with "
        "the plain version, as the JAX package's does)")


def mlp_exec_run(cfg, params, batches, steps, microbatches, policy, *,
                 verify=None) -> dict:
    """``steps`` Executor steps of ``cfg`` over ``InprocTransport``: K
    ``build_mlp_worker``s serving their columns of ``batches`` (already on
    the card) under local SGD, role 0's server under the port's SGD.
    Launch counters reset just before the run and read just after.  With
    ``verify`` (protocol_step's grads for step 0), step 0's grads must
    match them within 1e-5."""
    K = cfg.num_clients
    loss_fn = lambda logits, y: split_model.softmax_xent(logits, y,
                                                         cfg.num_classes)
    workers = [build_mlp_worker(
        k, cfg=cfg, batch=MLP_BATCH, microbatches=microbatches,
        learning_rate=EXEC_LR, params=params,
        features=lambda step: batches[step][0], device="cuda")
        for k in range(K)]
    opt = SGD(learning_rate=EXEC_LR)
    server = params["server"]
    state = opt.init(server)
    losses = []
    with InprocTransport(workers) as tr:
        executor = Executor(tr, towers.mlp_tower_apply, loss_fn, cfg.merge,
                            mode="pipelined", microbatches=microbatches,
                            drop_policy=policy)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for step in range(steps):
            res = executor.run_step(server, batches[step][1], step=step,
                                    collect_grads=step == 0)
            if step == 0:
                first = res
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            server, state = opt.update(server, res.server_grads, state)
            losses.append(res.loss)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = read_launches()
    losses = torch.stack(losses).tolist()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"executor {cfg.merge}: non-finite loss")
    dgrad = None
    if verify is not None:
        dgrad = max(float((a - b).abs().max()) for a, b in zip(
            _leaves([first.tower_grads, first.server_grads]),
            _leaves(list(verify))))
        if dgrad > 1e-5:
            raise AssertionError(f"executor {cfg.merge} M={microbatches}: "
                                 f"step-0 grads differ from protocol_step "
                                 f"by {dgrad:.3e} > 1e-5")
    tower_params = [w.params for w in workers]
    return dict(losses=losses, launches=launches, seconds=t_end - t0,
                steady_s=t_end - t1, dgrad=dgrad,
                params={"towers": tower_params, "server": server})


def mlp_protocol_grads(cfg, params, batch) -> tuple:
    """protocol_step (serial, the plain merge) on one batch: the reference
    for an Executor run's step-0 grads."""
    feats = [split_model.client_columns(batch[0], s)
             for s in split_model.feature_slices(cfg)]
    _, tg, sg, _ = protocol.protocol_step(
        towers.mlp_tower_apply, towers.mlp_tower_apply,
        lambda logits, y: split_model.softmax_xent(logits, y,
                                                   cfg.num_classes),
        params["towers"], params["server"], feats, batch[1], cfg.merge)
    return tg, sg


def busy_share(fn) -> tuple:
    """(wall seconds, device-busy seconds, kernel launches) of ``fn()``
    under ``torch.profiler``; busy is None where the profiler recorded no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in kernels) / 1e6
    return wall, (busy if kernels else None), sum(e.count for e in kernels)


def mlp_executor(card: str) -> dict:
    """Phase 10, part 2: PhraseBank (K = 4) through ``build_mlp_worker`` and
    the Executor over ``InprocTransport``, the merge kernels on the path.
    Returns the merge kernels' launches over the kernel runs."""
    name = "financial_phrasebank"
    ds = synthetic.to_device(synthetic.make_dataset(name, seed=SEED), "cuda")
    it = synthetic.minibatches(ds.x_train, ds.y_train, MLP_BATCH, seed=SEED,
                               epochs=1000)
    batches = [next(it) for _ in range(EXEC_STEPS)]
    total = dict.fromkeys(MERGE_CUDA_KERNELS, 0)
    runs = [("max", 1, EXEC_STEPS), ("max", 4, EXEC_SHORT)] + [
        (m, 1, EXEC_SHORT) for m in MLP_MERGES if m != "max"]
    for merge, mb, steps in runs:
        cfg = dataclasses.replace(PAPER_DATASETS[name], merge=merge)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = split_model.init_split_mlp(gen, cfg, device="cuda")
        verify = mlp_protocol_grads(cfg, params, batches[0])
        fused = mlp_exec_run(cfg, params, batches, steps, mb, "fused",
                             verify=verify)
        plain = mlp_exec_run(cfg, params, batches, steps, mb, "neutral")
        fwd, bwd = (("merge_concat_kernel", "merge_concat_bwd_kernel")
                    if merge == "concat" else
                    ("merge_reduce_kernel", "merge_reduce_bwd_kernel"))
        expect_launches(fused["launches"], {fwd: steps * mb, bwd: steps * mb})
        if any(plain["launches"].values()):
            raise AssertionError(f"executor {merge}: the neutral run "
                                 f"launched kernels: {plain['launches']}")
        diff = max(abs(a - b) for a, b in zip(fused["losses"],
                                               plain["losses"]))
        if diff > 1e-5:
            raise AssertionError(f"executor {merge} M={mb}: the kernel and "
                                 f"plain runs' losses differ by {diff:.3e}")
        for kernel in (fwd, bwd):
            total[kernel] += fused["launches"][kernel]
        acc, f1 = mlp_eval(cfg, ds, fused["params"])
        log(f"mlp executor {name} {merge} M={mb}: {steps} steps, "
            f"{fused['launches'][fwd]} {fwd} and {fused['launches'][bwd]} "
            f"{bwd} launches (one each per microbatch), step-0 max |dgrad| vs "
            f"protocol_step {fused['dgrad']:.3e} (<= 1e-5), losses "
            f"{fused['losses'][0]:.6f} -> {fused['losses'][-1]:.6f} within "
            f"{diff:.3e} of the neutral (plain-merge) run's, "
            f"{(steps - 1) / fused['steady_s']:.1f} steps/s over steps 1-"
            f"{steps - 1} ({(steps - 1) * MLP_BATCH / fused['steady_s']:.1f} "
            f"samples/s; neutral {(steps - 1) / plain['steady_s']:.1f} "
            f"steps/s), test acc / F1 {acc:.4f} / {f1:.4f} | {card}")
    # the device's busy share over EXEC_SHORT steps of the main run's
    # configuration (after the counted runs: launches here count nowhere)
    cfg = dataclasses.replace(PAPER_DATASETS[name], merge="max")
    params = split_model.init_split_mlp(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, device="cuda")
    wall, busy, n = busy_share(lambda: mlp_exec_run(
        cfg, params, batches, EXEC_SHORT, 1, "fused"))
    share = "not measured" if busy is None else (
        f"{busy:.6f} s busy = {100 * busy / wall:.2f}% of wall")
    log(f"mlp executor {name} max M=1 under the profiler: {EXEC_SHORT} steps "
        f"in {wall:.4f} s wall, {n} kernel launches, device {share} | {card}")
    return total


def mlp_bf16_card_vs_cpu(card: str) -> None:
    """PhraseBank with a bf16 tree (the path of Queue 3's first fault):
    ``split_forward`` on test rows, and one Executor step (four
    ``build_mlp_worker``s over ``InprocTransport``, the fused policy, 4
    microbatches), the card against the CPU from the same weights, within
    ``BF16_TOL``."""
    name = "financial_phrasebank"
    cfg = PAPER_DATASETS[name]
    ds = synthetic.make_dataset(name, seed=SEED)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    cpu_params = split_model.init_split_mlp(gen, cfg, dtype=torch.bfloat16,
                                            device="cpu")
    x = torch.as_tensor(ds.x_test[:MLP_BATCH], dtype=torch.float32)
    y = torch.as_tensor(ds.y_test[:MLP_BATCH]).long()
    out = {}
    for device in ("cpu", "cuda"):
        params = cpu_params if device == "cpu" else _to(cpu_params, device)
        xd, yd = x.to(device), y.to(device)
        logits = split_model.split_forward(params, xd, cfg)
        workers = [build_mlp_worker(k, cfg=cfg, batch=MLP_BATCH,
                                    microbatches=4, params=params,
                                    features=lambda step, xd=xd: xd,
                                    device=device)
                   for k in range(cfg.num_clients)]
        with InprocTransport(workers) as tr:
            ex = Executor(tr, towers.mlp_tower_apply,
                          lambda lg, lb: split_model.softmax_xent(
                              lg, lb, cfg.num_classes), cfg.merge,
                          microbatches=4)
            reset_launches()
            res = ex.run_step(params["server"], yd)
            launches = read_launches()
        out[device] = (logits, res, launches)
    expect_launches(out["cuda"][2], {"merge_reduce_kernel": 4,
                                     "merge_reduce_bwd_kernel": 4})
    if any(out["cpu"][2].values()):
        raise AssertionError(f"bf16 executor on the CPU launched kernels: "
                             f"{out['cpu'][2]}")
    logits, res = out["cuda"][0], out["cuda"][1]
    if logits.dtype != torch.float32:
        raise AssertionError(f"bf16 split_forward gave {logits.dtype}, not "
                             "the promoted float32")
    worst = {"logits": float((logits.cpu() - out["cpu"][0]).abs().max()),
             "loss": abs(float(res.loss) - float(out["cpu"][1].loss))}
    worst["grads"] = max(
        float((a.float().cpu() - b.float()).abs().max()) for a, b in zip(
            _leaves([res.tower_grads, res.server_grads]),
            _leaves([out["cpu"][1].tower_grads, out["cpu"][1].server_grads])))
    if max(worst.values()) > BF16_TOL:
        raise AssertionError(f"bf16 PhraseBank: card vs CPU {worst} > "
                             f"{BF16_TOL}")
    log(f"mlp bf16 {name} max: split_forward of {MLP_BATCH} test rows "
        f"(float32 logits) and one Executor step at 4 microbatches (4 + 4 "
        f"merge_reduce launches on the card), card vs CPU max |diff| "
        f"{worst} (<= {BF16_TOL}) | {card}")


def mlp_phase(card: str) -> dict:
    """Phase 10 (its merge kernels are checked and timed at the MLP shapes
    in phase 2); returns the launches per merge kernel."""
    t0 = time.perf_counter()
    mlp_tables(card)
    launches = mlp_executor(card)
    mlp_bf16_card_vs_cpu(card)
    log(f"mlp: phase 10 took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 11: no-wait split training
# ---------------------------------------------------------------------------

def nowait_sim_run(cfg, batches, params, device, plan, link) -> dict:
    """NOWAIT_SIM_STEPS of ``engine.pipelined_step(mode="nowait")`` under
    plain SGD on ``device`` (the simulated clock decides who made each
    merge; the Executor runs that liveness over SimTransport).  Launch
    counters reset just before the run and read just after."""
    slices = split_model.feature_slices(cfg)
    loss_fn = lambda logits, y: split_model.softmax_xent(logits, y,
                                                         cfg.num_classes)
    sgd = lambda p, g: p - NOWAIT_LR * g
    losses, lives, ema = [], [], None
    if device == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for xb, yb in batches[:NOWAIT_SIM_STEPS]:
        feats = [split_model.client_columns(xb, sl) for sl in slices]
        loss, tg, sg, _, report, ema = engine.pipelined_step(
            towers.mlp_tower_apply, towers.mlp_tower_apply, loss_fn,
            params["towers"], params["server"], feats, yb, cfg.merge,
            microbatches=NOWAIT_M, mode="nowait", plan=plan, link=link,
            ema_state=ema, device=device)
        params = {"towers": [tree_map(sgd, p, g)
                             for p, g in zip(params["towers"], tg)],
                  "server": tree_map(sgd, params["server"], sg)}
        losses.append(loss)
        lives.append(report.live)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    losses = torch.stack(losses).tolist()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"no-wait {cfg.merge} on {device}: non-finite "
                             "loss")
    return dict(losses=losses, lives=lives, launches=launches,
                seconds=seconds, params=params)


def nowait_sim_mlp(card: str) -> dict:
    """Phase 11 (a): PhraseBank at full size through ``pipelined_step`` on
    the simulated clock, client 1 a 20x straggler, avg and max: on the
    card and on the card's CPU from the same weights.  Returns the merge
    launches of the card runs."""
    name = "financial_phrasebank"
    ds = synthetic.make_dataset(name, seed=SEED)
    dsets = {d: synthetic.to_device(ds, d) for d in ("cuda", "cpu")}
    total = dict.fromkeys(MERGE_CUDA_KERNELS, 0)
    K, M, steps = 4, NOWAIT_M, NOWAIT_SIM_STEPS
    for merge in ("avg", "max"):
        cfg = dataclasses.replace(PAPER_DATASETS[name], merge=merge)
        plan = engine.plan_step(cfg, NOWAIT_BATCH, M)
        link = LinkModel.uniform(K).with_straggler(1,
                                                   slowdown=NOWAIT_SLOWDOWN)
        init = split_model.init_split_mlp(
            torch.Generator(device="cpu").manual_seed(SEED), cfg,
            device="cpu")
        runs = {}
        for device in ("cuda", "cpu"):
            it = synthetic.minibatches(dsets[device].x_train,
                                       dsets[device].y_train, NOWAIT_BATCH,
                                       seed=SEED, epochs=100)
            batches = [next(it) for _ in range(steps)]
            params = init if device == "cpu" else _to(init, device)
            runs[device] = nowait_sim_run(cfg, batches, params, device, plan,
                                          link)
        card_run, cpu_run = runs["cuda"], runs["cpu"]
        want_row = [1.0, 0.0, 1.0, 1.0]
        if any(row != want_row for live in card_run["lives"]
               for row in live):
            raise AssertionError(f"no-wait sim {merge}: live rows "
                                 f"{card_run['lives'][:2]} (client 1 should "
                                 "miss every microbatch, no other client)")
        if card_run["lives"] != cpu_run["lives"]:
            raise AssertionError(f"no-wait sim {merge}: card and CPU live "
                                 "matrices differ")
        diff = max(abs(a - b) for a, b in zip(card_run["losses"],
                                               cpu_run["losses"]))
        if diff > 1e-5:
            raise AssertionError(f"no-wait sim {merge}: card and CPU losses "
                                 f"differ by {diff:.3e} > 1e-5")
        expect_launches(card_run["launches"], {
            "merge_reduce_kernel": steps * M,
            "merge_reduce_bwd_kernel": steps * M})
        if any(cpu_run["launches"].values()):
            raise AssertionError(f"no-wait sim {merge}: the CPU run launched "
                                 f"kernels: {cpu_run['launches']}")
        first = sum(card_run["losses"][:5]) / 5
        last = sum(card_run["losses"][-5:]) / 5
        if not last < first:
            raise AssertionError(f"no-wait sim {merge}: mean loss of the "
                                 f"last five steps {last:.6f} is not below "
                                 f"the first five's {first:.6f}")
        for kernel in ("merge_reduce_kernel", "merge_reduce_bwd_kernel"):
            total[kernel] += card_run["launches"][kernel]
        acc, f1 = mlp_eval(cfg, dsets["cuda"], card_run["params"])
        cacc, cf1 = mlp_eval(cfg, dsets["cpu"], cpu_run["params"])
        log(f"nowait sim {name} {merge}: K={K}, batch {NOWAIT_BATCH}, "
            f"M={M}, client 1 {NOWAIT_SLOWDOWN:g}x slower (links and "
            f"compute), {steps} steps of SGD {NOWAIT_LR}: client 1 missed "
            f"all {steps * M} microbatches, no other client missed one; "
            f"live matrices identical on the card and the CPU; losses "
            f"{card_run['losses'][0]:.6f} -> {card_run['losses'][-1]:.6f} "
            f"(mean of first / last five {first:.6f} / {last:.6f}), within "
            f"{diff:.3e} of the CPU's per step; "
            f"{card_run['launches']['merge_reduce_kernel']} merge_reduce and "
            f"{card_run['launches']['merge_reduce_bwd_kernel']} "
            f"merge_reduce_bwd launches on the card (one each per "
            f"microbatch), none on the CPU; {steps / card_run['seconds']:.1f}"
            f" steps/s on the card ({card_run['seconds']:.4f} s; CPU "
            f"{steps / cpu_run['seconds']:.1f}); test acc / F1 card "
            f"{acc:.4f} / {f1:.4f}, CPU {cacc:.4f} / {cf1:.4f} | {card}")
    return total


def nowait_wall_run(cfg, params, batches, mode, deadline) -> dict:
    """NOWAIT_WALL_STEPS Executor steps over ``InprocTransport``: four
    ``build_mlp_worker``s (client 1 sleeping NOWAIT_DELAY_S per forward)
    under local SGD, role 0's server under SGD, the EMA threaded.  Launch
    counters reset just before the run and read just after."""
    K, M = cfg.num_clients, NOWAIT_M
    loss_fn = lambda logits, y: split_model.softmax_xent(logits, y,
                                                         cfg.num_classes)
    workers = [build_mlp_worker(
        k, cfg=cfg, batch=NOWAIT_BATCH, microbatches=M,
        learning_rate=NOWAIT_LR, params=params,
        features=lambda step: batches[step][0],
        forward_delay_s=NOWAIT_DELAY_S if k == 1 else 0.0, device="cuda")
        for k in range(K)]
    opt = SGD(learning_rate=NOWAIT_LR)
    server = params["server"]
    state = opt.init(server)
    ema, misses, used, course, losses, zero_steps = None, [], [], [], [], 0
    with InprocTransport(workers) as tr:
        ex = Executor(tr, towers.mlp_tower_apply, loss_fn, cfg.merge,
                      mode=mode, microbatches=M, deadline=deadline)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for step in range(NOWAIT_WALL_STEPS):
            res = ex.run_step(server, batches[step][1], step=step,
                              ema_state=ema)
            ema = res.ema_state
            server, state = opt.update(server, res.server_grads, state)
            misses.append(res.report.misses_per_client)
            used.append(res.report.deadline_s)
            if ex.deadline is not None:
                course.append(ex.deadline.deadline_s())
            losses.append(res.loss)
            if res.report.misses_per_client[1] == M:
                # it missed every microbatch: no jacobian, zero gradient
                if any(float(g.abs().max()) != 0.0
                       for g in _leaves(res.tower_grads[1])):
                    raise AssertionError(
                        f"no-wait {mode} step {step}: client 1 missed every "
                        "microbatch but its tower gradient is not zero")
                zero_steps += 1
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    losses = torch.stack(losses).tolist()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"no-wait {mode}: non-finite loss {losses}")
    expect_launches(launches, {"merge_reduce_kernel": NOWAIT_WALL_STEPS * M,
                               "merge_reduce_bwd_kernel":
                               NOWAIT_WALL_STEPS * M})
    return dict(misses=misses, used=used, course=course, losses=losses,
                seconds=seconds, launches=launches, zero_steps=zero_steps,
                spreads=ex.deadline.spreads() if ex.deadline else None)


def nowait_wall_mlp(card: str) -> dict:
    """Phase 11 (b): PhraseBank max over threads with a real straggler:
    no-wait with the adaptive deadline (``deadline=None``), no-wait with
    a static window, and the pipelined barrier beside them.  Returns the
    merge launches."""
    name = "financial_phrasebank"
    cfg = dataclasses.replace(PAPER_DATASETS[name], merge="max")
    ds = synthetic.to_device(synthetic.make_dataset(name, seed=SEED), "cuda")
    it = synthetic.minibatches(ds.x_train, ds.y_train, NOWAIT_BATCH,
                               seed=SEED, epochs=100)
    batches = [next(it) for _ in range(NOWAIT_WALL_STEPS)]
    params = split_model.init_split_mlp(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, device="cuda")
    total = dict.fromkeys(MERGE_CUDA_KERNELS, 0)
    M, steps = NOWAIT_M, NOWAIT_WALL_STEPS
    for label, mode, deadline in (("adaptive", "nowait", None),
                                  ("static", "nowait", NOWAIT_STATIC_S),
                                  ("pipelined", "pipelined", None)):
        run = nowait_wall_run(cfg, params, batches, mode, deadline)
        per_client = [sum(m[k] for m in run["misses"]) for k in range(4)]
        if label == "static" and per_client[1] != steps * M:
            raise AssertionError(f"no-wait static: client 1 missed "
                                 f"{per_client[1]} of {steps * M} "
                                 f"microbatches ({run['misses']})")
        if label == "pipelined" and any(per_client):
            raise AssertionError(f"pipelined: misses {per_client}")
        for kernel in ("merge_reduce_kernel", "merge_reduce_bwd_kernel"):
            total[kernel] += run["launches"][kernel]
        fmt = lambda xs: "[" + ", ".join(
            "none" if x is None else f"{x:.4f}" for x in xs) + "]"
        log(f"nowait wall {label} ({mode}, deadline "
            f"{'adaptive' if deadline is None else deadline}): {name} max, "
            f"K=4, batch {NOWAIT_BATCH}, M={M}, client 1 sleeping "
            f"{NOWAIT_DELAY_S} s per forward, {steps} steps: "
            f"{steps / run['seconds']:.2f} steps/s ({run['seconds']:.4f} s); "
            f"misses per client {per_client} of {steps * M} microbatches, "
            f"client 1 per step {[m[1] for m in run['misses']]}; steps on "
            f"which client 1 missed every microbatch and got a zero "
            f"gradient: {run['zero_steps']}; losses {run['losses'][0]:.6f} "
            f"-> {run['losses'][-1]:.6f}; "
            f"{run['launches']['merge_reduce_kernel']} merge_reduce and "
            f"{run['launches']['merge_reduce_bwd_kernel']} merge_reduce_bwd "
            f"launches | {card}")
        if mode == "nowait":
            log(f"nowait wall {label}: deadline used per step (s) "
                f"{fmt(run['used'])}; the controller's window after each "
                f"step (s) {fmt(run['course'])}; arrival-spread EWMAs at the "
                f"end {fmt(run['spreads'] or [])}")
    return total


@contextlib.contextmanager
def bootstrap_minimum(min_initial_s: float):
    """Every ``AdaptiveDeadline`` bootstraps its window from at least
    ``min_initial_s`` inside the block (the floor is half of it)."""
    seed = AdaptiveDeadline.seed_from_observations
    AdaptiveDeadline.seed_from_observations = (
        lambda self, min_initial_s=min_initial_s: seed(self, min_initial_s))
    try:
        yield
    finally:
        AdaptiveDeadline.seed_from_observations = seed


def nowait_lm_run(cfg, runtime, **kw):
    """``train_split`` of ``cfg`` over inproc, batch 8 x 256 tokens, M = 4,
    NOWAIT_LM_STEPS steps; returns (metrics, report, seconds, launches),
    the counters reset just before the run and read just after."""
    loader = LMBatchLoader(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    _, metrics, report = train_split(
        cfg, loader, steps=NOWAIT_LM_STEPS, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, runtime=runtime, microbatches=NOWAIT_M,
        learning_rate=3e-4, warmup=20, seed=SEED, log_every=1,
        device="cuda", print_fn=log, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if not all(math.isfinite(x) for x in metrics.losses):
        raise AssertionError(f"{runtime}: non-finite loss {metrics.losses}")
    per = NOWAIT_LM_STEPS * NOWAIT_M
    expect_launches(launches, {"merge_reduce_kernel": per,
                               "merge_reduce_bwd_kernel": per})
    return metrics, report, seconds, launches


def nowait_lm(card: str) -> int:
    """Phase 11 (c): full-width smollm-360m, ``train_split`` no-wait over
    inproc, without a straggler against the pipelined run at the same M,
    then with client 1 a straggler.  Returns the forward merge launches
    of the three runs (all at ``NOWAIT_SHAPE``; each backward kernel's
    count is the same)."""
    cfg = get_arch("smollm-360m")
    steps, M = NOWAIT_LM_STEPS, NOWAIT_M
    # warm-up at these shapes (not measured, its launches count nowhere):
    # the first run at M = 4 pays cuBLAS's and the allocator's start-up
    train_split(cfg, LMBatchLoader(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED),
                steps=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                runtime="pipelined", microbatches=M, seed=SEED,
                device="cuda", verify_step0=False, print_fn=lambda *a: None)
    piped, _, p_s, plaunches = nowait_lm_run(cfg, "pipelined")
    with bootstrap_minimum(NOWAIT_LM_BOOTSTRAP_S):
        nowait, report, n_s, launches = nowait_lm_run(cfg, "nowait")
    if any(any(m) for m in nowait.misses_per_client):
        raise AssertionError(f"no-wait smollm without a straggler missed: "
                             f"{nowait.misses_per_client}")
    if nowait.step0_max_dgrad is None or nowait.step0_max_dgrad > 1e-5:
        raise AssertionError(f"no-wait smollm: step 0 not verified "
                             f"({nowait.step0_max_dgrad})")
    diff = max(abs(a - b) for a, b in zip(nowait.losses, piped.losses))
    if diff > 1e-6:
        raise AssertionError(f"no-wait smollm: losses {nowait.losses} vs "
                             f"pipelined {piped.losses} differ by "
                             f"{diff:.3e} > 1e-6")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rate = lambda m: (len(m.step_times) - 1) / sum(m.step_times[1:])
    log(f"nowait smollm-360m: {steps} steps of {tokens} tokens at M={M} "
        f"(stack {NOWAIT_SHAPE}), no straggler, the window's bootstrap "
        f"minimum {NOWAIT_LM_BOOTSTRAP_S} s: 0 misses, step-0 max |dgrad| "
        f"vs protocol_step {nowait.step0_max_dgrad:.3e} (<= 1e-5), losses "
        f"{nowait.losses} within {diff:.3e} of the pipelined run's; "
        f"{launches['merge_reduce_kernel']} merge_reduce and "
        f"{launches['merge_reduce_bwd_kernel']} merge_reduce_bwd launches; "
        f"{rate(nowait):.3f} steps/s over steps 1-{steps - 1} (pipelined "
        f"{rate(piped):.3f}), wall {n_s:.4f} s (pipelined {p_s:.4f} s), "
        f"last deadline {report.deadline_s} | {card}")
    slow, sreport, s_s, slaunches = nowait_lm_run(
        cfg, "nowait", straggler=1, straggler_delay_s=NOWAIT_LM_DELAY_S)
    per_client = [sum(m[k] for m in slow.misses_per_client)
                  for k in range(cfg.vertical.num_clients)]
    log(f"nowait smollm-360m, client 1 sleeping {NOWAIT_LM_DELAY_S} s per "
        f"forward, the default adaptive window: misses per client "
        f"{per_client} of {steps * M} microbatches (per step "
        f"{slow.misses_per_client}), losses {slow.losses} (finite), step 0 "
        f"verified {slow.step0_max_dgrad is not None}; {rate(slow):.3f} steps/s "
        f"over steps 1-{steps - 1}, wall {s_s:.4f} s; "
        f"{slaunches['merge_reduce_kernel']} merge_reduce and "
        f"{slaunches['merge_reduce_bwd_kernel']} merge_reduce_bwd launches; "
        f"last deadline {sreport.deadline_s} | {card}")
    return sum(n["merge_reduce_kernel"]
               for n in (plaunches, launches, slaunches))


def nowait_phase(card: str) -> tuple[dict, int]:
    """Phase 11; returns (the merge kernels' launches over its MLP runs,
    the forward launches at ``NOWAIT_SHAPE``).  The LM runs' launches at
    that shape, backward included, are counted in the first as well."""
    t0 = time.perf_counter()
    launches = nowait_sim_mlp(card)
    for kernel, n in nowait_wall_mlp(card).items():
        launches[kernel] += n
    lm = nowait_lm(card)
    launches["merge_reduce_kernel"] += lm
    launches["merge_reduce_bwd_kernel"] += lm
    log(f"nowait: phase 11 took {time.perf_counter() - t0:.1f} s")
    return launches, lm


# ---------------------------------------------------------------------------
# phase 12: ssm split training — mamba2-1.3b through both SSD kernels
# ---------------------------------------------------------------------------

def ssm_train_launches(cfg, steps: int, verified: bool) -> dict:
    """The kernel launches of a serial ``train_split`` of ``steps`` steps
    of the ssm family (M = 1): per step each server layer runs the SSD
    forward once and each tower layer twice (the worker re-runs its
    forward for the vjp), each layer's backward once, and one merge each
    way; a verified step 0 runs ``protocol_step`` once more, whose merge is
    the plain version."""
    v = cfg.vertical
    server, towers = cfg.num_layers - v.tower_layers, \
        v.num_clients * v.tower_layers
    runs = steps + int(verified)
    return {"ssd_chunk_kernel": runs * (server + 2 * towers),
            "ssd_chunk_bwd_kernel": runs * (server + towers),
            "merge_reduce_kernel": steps, "merge_reduce_bwd_kernel": steps}


def train_ssm_small_against_cpu() -> dict:
    """Phase 12 (a): reduced mamba2-1.3b, same weights, 2 steps of 8 x 256
    tokens on the card (both SSD kernels, the merge kernels) against 2 on
    the CPU (the plain versions): losses and final params within 1e-4,
    launch counts exact.  Returns the card run's launches."""
    cfg = get_arch("mamba2-1.3b").reduced()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    cpu_params = backbone.init_params(cfg, gen, device="cpu")
    runs = {}
    for device, params in (("cpu", cpu_params),
                           ("cuda", _to(cpu_params, "cuda"))):
        out, metrics, _, launches, _ = train(cfg, 2, device, params=params)
        runs[device] = (out, metrics.losses)
        if device == "cpu" and any(launches.values()):
            raise AssertionError(f"the CPU run launched kernels: {launches}")
    expect_launches(launches, ssm_train_launches(cfg, 2, True))
    torch.testing.assert_close(torch.tensor(runs["cuda"][1]),
                               torch.tensor(runs["cpu"][1]), rtol=1e-4,
                               atol=1e-4)
    worst = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        _leaves(runs["cuda"][0]), _leaves(runs["cpu"][0])))
    if worst > 1e-4:
        raise AssertionError(f"reduced mamba2: card params differ from the "
                             f"CPU path by {worst:.3e} > 1e-4")
    log(f"ssm train small: reduced mamba2-1.3b (chunk {cfg.ssm.chunk_size}, "
        f"d_state {cfg.ssm.d_state}), 2 steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens on the card match the CPU path (losses "
        f"{runs['cuda'][1]} vs {runs['cpu'][1]}; final params max |diff| "
        f"{worst:.3e} <= 1e-4); launches {launches}")
    return launches


def train_ssm_full(card: str) -> dict:
    """Phase 12 (b): full-width mamba2-1.3b trained split, serial, 8 x 256
    tokens, after one warm-up step: losses, step 0 against protocol_step,
    train tokens/s over steps 1-4, peak memory, exact launch counts.
    Returns the launches."""
    cfg = get_arch("mamba2-1.3b")
    v = cfg.vertical
    train(cfg, 1, "cuda", verify_step0=False)  # warm-up, not measured
    torch.cuda.empty_cache()
    _, metrics, seconds, launches, peak = train(cfg, TRAIN_STEPS, "cuda")
    expect_launches(launches, ssm_train_launches(cfg, TRAIN_STEPS, True))
    if metrics.step0_max_dgrad is None or metrics.step0_max_dgrad > 1e-5:
        raise AssertionError(f"ssm train: step 0 not verified "
                             f"({metrics.step0_max_dgrad})")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = metrics.step_times[1:]
    log(f"ssm train: {cfg.name} full width ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}; K={v.num_clients} towers of {v.tower_layers} "
        f"layers, merge {v.merge}, {cfg.num_layers - v.tower_layers} server "
        f"layers), f32, serial, {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens: losses {metrics.losses}, step-0 max |dgrad| "
        f"vs protocol_step {metrics.step0_max_dgrad:.3e} (<= 1e-5); "
        f"launches {launches} | {card}")
    log(f"ssm train: {len(steady) * tokens / sum(steady):.1f} train tokens/s "
        f"over steps 1-{TRAIN_STEPS - 1} (step times {metrics.step_times} s; "
        f"step 0 includes the verification), wall {seconds:.4f} s with "
        f"set-up, max_memory_allocated {peak} bytes | {card}")
    return launches


def ssm_train_phase(card: str) -> dict:
    """Phase 12; returns the launches of (a) and (b) summed, and (b)'s
    alone under the key ``"full"``."""
    t0 = time.perf_counter()
    small = train_ssm_small_against_cpu()
    full = train_ssm_full(card)
    log(f"ssm train: phase 12 took {time.perf_counter() - t0:.1f} s")
    return {**{k: small[k] + full[k] for k in full}, "full": full}


# ---------------------------------------------------------------------------
# phase 13: monolithic dense serving
# ---------------------------------------------------------------------------

def mono_small_against_cpu() -> None:
    """Reduced smollm-360m, same weights: the card against the CPU path.
    ``generate`` on a linear cache and on a ring under a window (prefill
    logits within 1e-5, greedy tokens identical); 4 decode chunks step
    by step from an empty cache, over the f32 cache (logits within 1e-5,
    argmax identical) and over int8 (int8 has no prefill).  The int8
    runs are held to each other as int8 is held to f32: K/V within one
    int8 level, relative error below 0.02, argmax agreement above 0.9.
    An input that lands within ~1e-6 of half a step rounds to either
    side on the two devices, and a few such one-level flips move the
    reduced model's logits by up to 1.5e-3 (measured on the CPU with
    inputs perturbed by 1e-6)."""
    cfg = get_arch("smollm-360m").reduced()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    cpu_params = backbone.init_params(cfg, gen, device="cpu")
    gpu_params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (2, 8))
    diffs = {}
    for label, kw in (("linear", dict(max_new_tokens=8)),
                      ("window+ring", dict(max_new_tokens=12, cache_len=8,
                                           window=8, ring=True))):
        out = {}
        for device, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            cache = backbone.init_cache(cfg, 2, kw.get("cache_len", 16),
                                        ring=kw.get("ring", False),
                                        device=device)
            logits, _ = backbone.prefill_tokens(
                params, cache, torch.as_tensor(prompts, device=device), cfg)
            out[device] = (logits.cpu(),
                           generate(params, cfg, prompts, **kw).cpu())
        diffs[label] = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        if diffs[label] > 1e-5 or not torch.isfinite(out["cuda"][0]).all():
            raise AssertionError(f"mono small {label}: prefill logits differ "
                                 f"by {diffs[label]}")
        if not torch.equal(out["cuda"][1], out["cpu"][1]):
            raise AssertionError(f"mono small {label}: card tokens "
                                 f"{out['cuda'][1].tolist()} vs CPU "
                                 f"{out['cpu'][1].tolist()}")
    # decode chunks over the f32 cache, then over int8, 16 steps from an
    # empty cache (int8 has no prefill)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    runs = {}
    for quant in (False, True):
        for device, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            cache = backbone.init_cache(cfg, 2, 16, kv_quant=quant,
                                        device=device)
            steps = []
            for t in range(toks.shape[1]):
                logits, cache = backbone.decode_step(
                    params, cache, torch.as_tensor(toks[:, t], device=device),
                    cfg, decode_chunks=MONO_INT8_CHUNKS)
                steps.append(logits.cpu())
            runs[quant, device] = (torch.stack(steps, 1), _to(cache, "cpu"))
    fp = {d: runs[False, d][0] for d in ("cpu", "cuda")}
    diffs["chunks"] = float((fp["cuda"] - fp["cpu"]).abs().max())
    if diffs["chunks"] > 1e-5 or not torch.equal(fp["cuda"].argmax(-1),
                                                 fp["cpu"].argmax(-1)):
        raise AssertionError(f"mono small chunks: logits differ by "
                             f"{diffs['chunks']} or argmax differs")
    (q8, c_cpu), (q8_card, c_card) = runs[True, "cpu"], runs[True, "cuda"]
    levels = max(int((c_card[key].int() - c_cpu[key].int()).abs().max())
                 for key in ("k", "v"))
    rel = float((q8_card - q8).abs().max() / q8.abs().max())
    agree = float((q8_card.argmax(-1) == q8.argmax(-1)).float().mean())
    diffs["int8+chunks"] = {"levels": levels, "rel": rel, "agree": agree}
    if levels > 1 or rel >= MONO_INT8_REL or agree <= MONO_INT8_AGREE:
        raise AssertionError(f"mono small int8: {diffs['int8+chunks']}")
    log(f"mono small: reduced smollm-360m on the card matches the CPU path "
        f"(generate, linear and window+ring: prefill logits within 1e-5, "
        f"identical greedy tokens; {MONO_INT8_CHUNKS} decode chunks over "
        f"16 steps: logits within 1e-5, identical argmax; int8 with chunks: "
        f"caches within one level, relative error < {MONO_INT8_REL}, argmax "
        f"agreement > {MONO_INT8_AGREE}): {diffs}")


def mono_generate(cfg, params, prompts, **kw):
    """``generate`` timed (host clock, synchronised); returns (tokens as
    lists, seconds, launches during the run)."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if out.device.type != "cuda" or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"generate: tokens on {out.device} or out of "
                             "vocab")
    return out.tolist(), seconds, launches


def mono_prefill(cfg, params, prompt, use_kernel: bool = True):
    """``prefill_tokens`` of ``prompt`` into a fresh cache, timed; returns
    (last logits, seconds, launches during the run)."""
    cache = backbone.init_cache(cfg, prompt.shape[0],
                                prompt.shape[1] + MONO_NEW, device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, _ = backbone.prefill_tokens(params, cache, prompt, cfg,
                                        use_kernel=use_kernel)
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0, read_launches()


def mono_int8(cfg, params, rng) -> tuple:
    """int8 KV with decode chunks against the f32 cache, step by step from
    an empty cache over the same tokens: (relative error, argmax
    agreement), held to the JAX package's bounds."""
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
        MONO_INT8_BATCH, MONO_INT8_STEPS)), device="cuda")
    c_fp = backbone.init_cache(cfg, MONO_INT8_BATCH, MONO_INT8_STEPS,
                               device="cuda")
    c_q8 = backbone.init_cache(cfg, MONO_INT8_BATCH, MONO_INT8_STEPS,
                               kv_quant=True, device="cuda")
    fp, q8 = [], []
    for t in range(MONO_INT8_STEPS):
        logits, c_fp = backbone.decode_step(params, c_fp, toks[:, t], cfg)
        fp.append(logits)
        logits, c_q8 = backbone.decode_step(params, c_q8, toks[:, t], cfg,
                                            decode_chunks=MONO_INT8_CHUNKS)
        q8.append(logits)
    fp, q8 = torch.stack(fp, 1), torch.stack(q8, 1)
    if c_q8["k"].dtype != torch.int8 or not torch.isfinite(q8).all():
        raise AssertionError("int8 decode: cache not int8 or logits not "
                             "finite")
    rel = float((fp - q8).abs().max() / fp.abs().max())
    agree = float((fp.argmax(-1) == q8.argmax(-1)).float().mean())
    if rel >= MONO_INT8_REL or agree <= MONO_INT8_AGREE:
        raise AssertionError(f"int8 decode: relative error {rel} (< "
                             f"{MONO_INT8_REL}), argmax agreement {agree} (> "
                             f"{MONO_INT8_AGREE})")
    return rel, agree


def decode_bytes(cfg, n_params: int, batch: int, cache_len: int) -> int:
    """Bytes a decode step must move at least, f32: every weight once (the
    tied table once, for the unembedding) and every K/V slot of the
    server and the towers once."""
    v = cfg.vertical
    dims = BlockDims.from_arch(cfg)
    kv_t = dims.scaled(v.num_clients).n_kv_heads
    slots = batch * cache_len * dims.head_dim * 2 * (
        (cfg.num_layers - v.tower_layers) * dims.n_kv_heads
        + v.num_clients * v.tower_layers * kv_t)
    return 4 * (n_params + slots)


def mono_probe(cfg, params, n_params: int, card: str) -> list:
    """``batched_throughput_probe`` by batch at a linear cache of 4096,
    and at the ring of ``cfg.sliding_window`` (window = its length)."""
    rows = []
    plans = [(b, MONO_PROBE_LEN, False) for b in MONO_PROBE_BATCHES]
    plans.append((MONO_RING_PROBE_BATCH, cfg.sliding_window, True))
    for batch, cache_len, ring in plans:
        torch.cuda.empty_cache()
        rep = batched_throughput_probe(
            params, cfg, batch=batch, cache_len=cache_len,
            steps=MONO_PROBE_STEPS, window=cache_len if ring else None,
            ring=ring)
        bound_ms = decode_bytes(cfg, n_params, batch,
                                cache_len) / H100_BYTES_PER_S * 1e3
        rows.append({**rep, "cache_len": cache_len, "bound_ms": bound_ms})
        log(f"mono probe: batch {batch}, {'ring' if ring else 'linear'} "
            f"cache {cache_len}{f', window {cache_len}' if ring else ''}: "
            f"{rep['tokens_per_s']:.1f} decode tokens/s, "
            f"{rep['ms_per_step']:.4f} ms a step (median of "
            f"{MONO_PROBE_STEPS}); byte bound {bound_ms:.4f} ms a step | "
            f"{card}")
    return rows


def mono_phase(card: str) -> int:
    """Phase 13; returns the flash launches of its main path (the
    4096-token ``generate``)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    mono_small_against_cpu()
    cfg = get_arch("smollm-360m")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = backbone.init_params(cfg, gen, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    K, Lt = cfg.vertical.num_clients, cfg.vertical.tower_layers
    per_prompt = cfg.num_layers - Lt + K * Lt
    rng = np.random.default_rng(SEED)
    short = rng.integers(0, cfg.vocab_size, MONO_SHORT)
    long = rng.integers(0, cfg.vocab_size, (1, MONO_LONG))
    log(f"mono: {cfg.name} full width, {n_params} params f32, K={K} towers "
        f"of {Lt} layers (plain merge), {cfg.num_layers - Lt} server layers; "
        f"generate {MONO_SHORT[0]} x {MONO_SHORT[1]} and 1 x {MONO_LONG} "
        f"prompt tokens, {MONO_NEW} new each")
    # warm-up (not measured): cuBLAS, the flash kernel's first launch
    generate(params, cfg, long[:, :2304], max_new_tokens=2)

    # (b) the main path: counters reset just before, read just after
    torch.cuda.reset_peak_memory_stats()
    long_tokens, t_long, launches = mono_generate(cfg, params, long,
                                                  max_new_tokens=MONO_NEW)
    peak = torch.cuda.max_memory_allocated()
    expect_launches(launches, {"flash_attention_kernel": per_prompt,
                               flash_name(64): per_prompt})
    short_tokens, t_short, slaunch = mono_generate(cfg, params, short,
                                                   max_new_tokens=MONO_NEW)
    expect_launches(slaunch, {})
    split_short, _, _, _ = serve(cfg, params, list(short),
                                 [MONO_NEW] * MONO_SHORT[0],
                                 cache_len=MONO_SHORT[1] + MONO_NEW,
                                 max_batch=MONO_SHORT[0])
    split_long, _, _, _ = serve(cfg, params, list(long), [MONO_NEW],
                                cache_len=MONO_LONG + MONO_NEW, max_batch=1)
    if split_short != short_tokens or split_long != long_tokens:
        raise AssertionError(f"generate differs from SplitLMServer: "
                             f"{short_tokens + long_tokens} vs "
                             f"{split_short + split_long}")
    logits, t_prefill, _ = mono_prefill(cfg, params, torch.as_tensor(
        long, device="cuda"))
    plain, t_plain, plaunch = mono_prefill(cfg, params, torch.as_tensor(
        long, device="cuda"), use_kernel=False)
    if any(plaunch.values()):
        raise AssertionError(f"the plain prefill launched kernels: "
                             f"{plaunch}")
    diff = float((logits - plain).abs().max())
    if diff > 1e-3 or not torch.isfinite(logits).all():
        raise AssertionError(f"4096-token prefill: kernel vs plain logits "
                             f"differ by {diff} (tol 1e-3)")
    log(f"mono generate: {per_prompt} flash_attention_kernel launches for "
        f"the {MONO_LONG}-token prompt ({cfg.num_layers - Lt} server + "
        f"{K} x {Lt} tower layers), no merge kernel; greedy tokens equal "
        f"SplitLMServer's for all {MONO_SHORT[0] + 1} prompts; prefill "
        f"logits kernel vs plain max |diff| {diff:.3e} (tol 1e-3) | {card}")
    log(f"mono prefill: {MONO_LONG} tokens in {t_prefill:.4f} s = "
        f"{MONO_LONG / t_prefill:.1f} prefill tokens/s (plain attention "
        f"{t_plain:.4f} s); generate 1 x ({MONO_LONG} + {MONO_NEW}) "
        f"{t_long:.4f} s, {MONO_SHORT[0]} x ({MONO_SHORT[1]} + {MONO_NEW}) "
        f"{t_short:.4f} s ({MONO_SHORT[0] * MONO_NEW / t_short:.1f} tokens/s "
        f"with the prefill); max_memory_allocated {peak} bytes | {card}")

    # (c) a ring of 256 slots against a linear cache under the same window
    prompts = rng.integers(0, cfg.vocab_size,
                           (MONO_RING_BATCH, MONO_RING_PROMPT))
    lin, t_lin, _ = mono_generate(cfg, params, prompts,
                                  max_new_tokens=MONO_RING, window=MONO_RING)
    ring, t_ring, _ = mono_generate(cfg, params, prompts,
                                    max_new_tokens=MONO_RING,
                                    cache_len=MONO_RING, window=MONO_RING,
                                    ring=True)
    if ring != lin:
        raise AssertionError("ring cache tokens differ from the linear "
                             "cache's under the same window")
    log(f"mono ring: {MONO_RING_BATCH} x ({MONO_RING_PROMPT} + {MONO_RING}) "
        f"tokens, window {MONO_RING}: a ring of {MONO_RING} slots gives the "
        f"tokens of a linear cache of {MONO_RING_PROMPT + MONO_RING}; "
        f"{t_ring:.4f} s vs {t_lin:.4f} s "
        f"({MONO_RING_BATCH * MONO_RING / t_ring:.1f} vs "
        f"{MONO_RING_BATCH * MONO_RING / t_lin:.1f} tokens/s) | {card}")

    # (d) int8 KV with decode chunks against f32
    rel, agree = mono_int8(cfg, params, rng)
    log(f"mono int8: {MONO_INT8_BATCH} streams x {MONO_INT8_STEPS} decode "
        f"steps, int8 KV with {MONO_INT8_CHUNKS} decode chunks vs f32: "
        f"relative error {rel:.4e} (< {MONO_INT8_REL}), argmax agreement "
        f"{agree:.4f} (> {MONO_INT8_AGREE})")

    # (e) decode throughput by batch and cache plan
    mono_probe(cfg, params, n_params, card)
    log(f"mono: phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return launches["flash_attention_kernel"]


# ---------------------------------------------------------------------------
# phase 14: the training launcher — one process per feature holder,
# monolithic and centralized training, checkpoints, the CLI
# ---------------------------------------------------------------------------

def card_memory() -> tuple:
    """One reading of the card's memory: ``nvidia-smi``'s compute
    processes as (pid, MiB) rows, and the card's total ``memory.used`` in
    MiB."""
    def query(*args) -> list:
        out = subprocess.run(["nvidia-smi", *args,
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        return [line.strip() for line in out.stdout.strip().splitlines()]

    rows = [tuple(part.strip() for part in line.split(","))
            for line in query("--query-compute-apps=pid,used_memory")]
    total = query("--query-gpu=memory.used")
    return rows, (int(total[0]) if total and total[0].isdigit() else None)


def by_route(ledger) -> list:
    """A step's ledger as sorted (sender, receiver, tag, bytes): the
    transports deliver cuts in arrival order."""
    return sorted((m.sender, m.receiver, m.tag, m.num_bytes)
                  for m in ledger.messages)


def launch_small_card_vs_card() -> dict:
    """(a) Reduced smollm-360m, seeded on the card in role 0 and in every
    feature holder: 3 steps over spawned processes against 3 over
    threads — losses and final params within 1e-6, the per-step ledgers
    equal, one merge each way per step in both.  Returns the launches of
    both runs."""
    cfg = get_arch("smollm-360m").reduced()
    runs, total = {}, {}
    for transport in ("inproc", "multiproc"):
        out, metrics, _, launches, _ = train(cfg, LAUNCH_STEPS, "cuda",
                                             transport=transport)
        expect_launches(launches, {"merge_reduce_kernel": LAUNCH_STEPS,
                                   "merge_reduce_bwd_kernel": LAUNCH_STEPS})
        runs[transport] = (out, metrics)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    (out, metrics), (iout, imetrics) = runs["multiproc"], runs["inproc"]
    loss_diff = max(abs(a - b) for a, b in zip(metrics.losses,
                                               imetrics.losses))
    worst = max(float((a - b).abs().max()) for a, b in zip(
        _leaves(out), _leaves(iout)))
    if loss_diff > SAME_TOL or worst > SAME_TOL:
        raise AssertionError(f"launch small: multiproc vs inproc losses "
                             f"{loss_diff:.3e}, params {worst:.3e} > "
                             f"{SAME_TOL}")
    if [by_route(x) for x in metrics.ledgers] != \
            [by_route(x) for x in imetrics.ledgers]:
        raise AssertionError("launch small: multiproc ledgers differ from "
                             "inproc's")
    log(f"launch small: reduced smollm-360m seeded on the card, "
        f"{LAUNCH_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}: multiproc "
        f"(K={cfg.vertical.num_clients} processes) vs inproc losses max "
        f"|diff| {loss_diff:.3e}, final params {worst:.3e} (<= {SAME_TOL}); "
        f"ledgers equal ({metrics.ledgers[0].total()} bytes a step); "
        f"multiproc set-up {metrics.setup_s:.2f} s")
    return total


def launch_multiproc_full(card: str) -> dict:
    """(b) Full-width smollm-360m through ``train_split`` over four
    spawned feature holders on the card, serial, 5 steps of 8 x 256
    (step 0 is the children's warm-up and is verified against
    protocol_step at 1e-5): one merge each way per step at role 0, train
    tokens/s over steps 1-4 beside phase 4's threads, the set-up time,
    and the card's memory by process as ``nvidia-smi`` lists it, read
    once while every process is alive.  Returns the launches."""
    cfg = get_arch("smollm-360m")
    torch.cuda.empty_cache()
    memory = {}

    def read_memory_at_last_step(line: str) -> None:
        # every process is alive here, and the reading's time falls into
        # no timed step (the last step's time is taken before its line)
        log(line)
        if line.startswith(f"step {TRAIN_STEPS - 1:5d}"):
            memory["rows"], memory["total_mib"] = card_memory()
            memory["role0_reserved"] = torch.cuda.memory_reserved()

    _, metrics, seconds, launches, peak = train(
        cfg, TRAIN_STEPS, "cuda", transport="multiproc",
        print_fn=read_memory_at_last_step)
    expect_launches(launches, {"merge_reduce_kernel": TRAIN_STEPS,
                               "merge_reduce_bwd_kernel": TRAIN_STEPS})
    if metrics.step0_max_dgrad is None or metrics.step0_max_dgrad > 1e-5:
        raise AssertionError(f"multiproc train: step 0 not verified "
                             f"({metrics.step0_max_dgrad})")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = metrics.step_times[1:]
    rate = len(steady) * tokens / sum(steady)
    inproc = MEASURED.get("inproc_train_tokens_s")
    MEASURED["multiproc_train_tokens_s"] = rate
    log(f"multiproc train: {cfg.name} full width, K="
        f"{cfg.vertical.num_clients} spawned processes on the card, "
        f"{TRAIN_STEPS} steps of {tokens} tokens, losses {metrics.losses}, "
        f"step-0 max |dgrad| vs protocol_step "
        f"{metrics.step0_max_dgrad:.3e} (<= 1e-5); launches {launches} | "
        f"{card}")
    log(f"multiproc train: {rate:.1f} train tokens/s over steps 1-"
        f"{TRAIN_STEPS - 1} (step times {metrics.step_times} s) vs "
        f"{inproc if inproc is None else round(inproc, 1)} over threads "
        f"(phase 4, this run); spawn and connect {metrics.setup_s:.2f} s; "
        f"wall {seconds:.4f} s; role 0 max_memory_allocated {peak} bytes, "
        f"memory_reserved {memory['role0_reserved']} bytes at the last "
        f"step; nvidia-smi at the last step: compute processes (pid, MiB) "
        f"{memory['rows']}, card memory.used {memory['total_mib']} MiB | "
        f"{card}")
    return launches


def launch_serve_multiproc(card: str) -> int:
    """(c) Phase 3's 8 requests through ``SplitLMServer`` over four
    spawned feature holders (seeded on the card): tokens equal phase 3's
    continuous run, bytes equal ``costs.serve_*``, every merge through
    the kernel.  Returns the merge launches."""
    cfg = get_arch("smollm-360m")
    K = cfg.vertical.num_clients
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    _, server = split_program.get_program(cfg).partition(
        backbone.init_params(cfg, gen, device="cuda"))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, s) for s in PROMPT_LENS]
    cache_len = max(s + n for s, n in zip(PROMPT_LENS, NEW_TOKENS))
    specs = [WorkerSpec(build_split_worker,
                        dict(cfg=cfg, seed=SEED, device="cuda"))
             for _ in range(K)]
    t0 = time.perf_counter()
    with MultiprocTransport(specs, device="cuda") as tr:
        setup = time.perf_counter() - t0
        srv = SplitLMServer(tr, cfg, server, device="cuda",
                            cache_len=cache_len, max_batch=4,
                            continuous=True)
        for prompt, n in zip(prompts, NEW_TOKENS):
            srv.submit(prompt, max_new_tokens=n)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        results = srv.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    tokens = [r.tokens for r in results]
    if tokens != MEASURED["serve"]["tokens"]:
        raise AssertionError("multiproc serving gave other tokens than "
                             "phase 3")
    merges = expect_merges(srv.stats, NEW_TOKENS, launches,
                           "merge_reduce_kernel")
    rounds = srv.stats["tokens"] - srv.stats["requests"]
    pf = costs.serve_prefill_bytes(sum(PROMPT_LENS), cfg.d_model, K)
    dc = costs.serve_decode_bytes(cfg.d_model, K, rounds=rounds)
    led = srv.ledger
    if (led.sent_by("role0"), led.received_by("role0"),
            srv.wire_report()["total"]) != (
            pf["role0_sent"] + dc["role0_sent"],
            pf["role0_received"] + dc["role0_received"],
            pf["total"] + dc["total"]):
        raise AssertionError("multiproc serving: ledger differs from "
                             "costs.serve_*")
    log(f"multiproc serve: {len(prompts)} requests, {srv.stats['tokens']} "
        f"tokens, {srv.stats['decode_rounds']} decode rounds over {K} "
        f"spawned processes: tokens equal phase 3's, {merges} "
        f"merge_reduce_kernel launches, {led.total()} bytes = "
        f"costs.serve_*; wall {seconds:.4f} s vs "
        f"{MEASURED['serve']['seconds']:.4f} s over the inline transport "
        f"(phase 3); spawn and connect "
        f"{setup:.2f} s | {card}")
    return merges


def ssd_per_mono_step(cfg) -> int:
    """SSD launches of one monolithic ssm step, each way: every server
    layer and every tower layer runs once (no re-run for a vjp)."""
    v = cfg.vertical
    return cfg.num_layers - v.tower_layers + v.num_clients * v.tower_layers


def launch_mono(card: str) -> dict:
    """(d) The monolithic ``train`` (in process), 3 steps of 8 x 256 each:
    full-width smollm-360m vertical (with a checkpoint saved and loaded
    back bit for bit) and centralized, and mamba2-1.3b vertical (exact
    counts of both SSD kernels: 54 a step each way); train tokens/s over
    steps 1-2 and peak memory.  Returns the launches."""
    smollm = get_arch("smollm-360m")
    ckpt = LAUNCH_DIR / "smollm.msgpack"
    total: dict = {}
    for label, cfg, path in (
            ("smollm-360m", smollm, ckpt),
            ("smollm-360m --vertical off", smollm.with_vertical(None), None),
            ("mamba2-1.3b", get_arch("mamba2-1.3b"), None)):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        params, metrics = train_mono(
            cfg, LMBatchLoader(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED),
            steps=LAUNCH_STEPS, seed=SEED, device="cuda", log_every=1,
            checkpoint_path=None if path is None else str(path),
            print_fn=log)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in metrics.losses):
            raise AssertionError(f"mono train {label}: {metrics.losses}")
        want = {}
        if cfg.family == "ssm":
            n = LAUNCH_STEPS * ssd_per_mono_step(cfg)
            want = {"ssd_chunk_kernel": n, "ssd_chunk_bwd_kernel": n}
        expect_launches(launches, want)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        if path is not None:
            loaded, step = load_checkpoint(str(path), device="cuda")
            same = step == LAUNCH_STEPS and all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(_leaves(loaded), _leaves(params)))
            size = path.stat().st_size
            path.unlink()
            if not same:
                raise AssertionError("mono train: the checkpoint did not "
                                     "load back bit for bit")
            del loaded
        steady = metrics.step_times[1:]
        log(f"mono train: {label}, {backbone.param_count(cfg)} params f32, "
            f"{LAUNCH_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
            f"{metrics.losses}; "
            f"{len(steady) * TRAIN_BATCH * TRAIN_SEQ / sum(steady):.1f} "
            f"train tokens/s over steps 1-{LAUNCH_STEPS - 1} (step times "
            f"{metrics.step_times} s), wall {seconds:.4f} s"
            + (f" with the checkpoint ({size} bytes, loaded back bit for "
               "bit)" if path is not None else "")
            + f"; launches {launches}; max_memory_allocated {peak} bytes | "
            f"{card}")
        del params
    return total


def launch_cli(card: str, extra: tuple = (),
               verified: str = "step-0 verification vs protocol_step"
               ) -> dict:
    """(e) ``python -m repro_torch.launch.train --transport multiproc`` as
    a user runs it (full-width smollm-360m, the card by default), with
    ``extra`` flags: exit 0, the ``verified`` step-0 line and the
    summary's keys."""
    out_json = LAUNCH_DIR / "launch.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--transport",
           "multiproc", "--steps", str(LAUNCH_STEPS), "--batch",
           str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), *extra, "--json",
           str(out_json)]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src")
               + (os.pathsep + path if path else ""))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # a session of its own, so that a timeout takes its children down too
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"launcher: no exit within {LAUNCH_TIMEOUT_S} s")
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"launcher exited {proc.returncode}: "
                             f"{stderr[-3000:]}")
    if verified not in stdout:
        raise AssertionError(f"launcher: no step-0 line in {stdout[-2000:]}")
    with open(out_json) as f:
        run = json.load(f)
    out_json.unlink()
    summary = run["summary"]
    keys = {"first_loss", "last_loss", "best_loss", "mean_step_s",
            "loss_drop", "arch", "params", "steps", "vertical", "transport",
            "inflight_steps", "secure_agg", "compress", "agg_tree_fanout",
            "runtime"}
    if set(summary) != keys or summary["transport"] != "multiproc" or \
            len(run["losses"]) != LAUNCH_STEPS:
        raise AssertionError(f"launcher summary: {summary}")
    step0 = next(line for line in stdout.splitlines() if verified in line)
    log(f"launcher: {' '.join(cmd[1:])}: exit 0 in {seconds:.1f} s; "
        f"{step0.strip()}; summary {json.dumps(summary)} | {card}")
    return summary


def launch_phase(card: str) -> dict:
    """Phase 14; returns the launches of its in-process runs (the
    launcher's subprocess counts in its own process)."""
    t0 = time.perf_counter()
    LAUNCH_DIR.mkdir(parents=True, exist_ok=True)
    total: dict = {}
    for part in (launch_small_card_vs_card(), launch_multiproc_full(card),
                 {"merge_reduce_kernel": launch_serve_multiproc(card)},
                 launch_mono(card)):
        for name, n in part.items():
            total[name] = total.get(name, 0) + n
    launch_cli(card)
    log(f"launch: phase 14 took {time.perf_counter() - t0:.1f} s; "
        f"launches {total}")
    return total


# ---------------------------------------------------------------------------
# phase 15: the wire overlays — cut compression, secure aggregation and
# aggregation trees
# ---------------------------------------------------------------------------

def overlay_cfg(base, overlay: str):
    """``base`` at K = 4 with the overlay's vertical settings; returns the
    config and the tree's fanout (None: a star)."""
    fields, fanout = OVERLAYS[overlay]
    return base.with_vertical(dataclasses.replace(
        base.vertical, num_clients=OVERLAY_K, **fields)), fanout


@contextlib.contextmanager
def merge_calls():
    """Role 0's fused merges, as (strategy, (K, rows, D)) per call: the
    Executor's ``fast_merge`` wrapped for the run (the serial verification
    merges with the plain version and is not seen)."""
    from repro_torch.runtime import executor as executor_mod

    seen, plain = [], executor_mod.fast_merge

    def spy(stacked, strategy, **kw):
        K, D = stacked.shape[0], stacked.shape[-1]
        seen.append((strategy, (K, stacked.numel() // (K * D), D)))
        return plain(stacked, strategy, **kw)

    executor_mod.fast_merge = spy
    try:
        yield seen
    finally:
        executor_mod.fast_merge = plain


@contextlib.contextmanager
def payload_sync_time():
    """Role 0's host seconds and calls in ``compression.payload_bytes``
    (its nonzero count is read back from the card: one sync a call)."""
    from repro_torch.core import compression as comp_lib

    spent, plain = {"s": 0.0, "calls": 0}, comp_lib.payload_bytes

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return plain(*args, **kw)
        finally:
            spent["s"] += time.perf_counter() - t0
            spent["calls"] += 1

    comp_lib.payload_bytes = timed
    try:
        yield spent
    finally:
        comp_lib.payload_bytes = plain


def overlay_wire_bytes(cfg, fanout, rows: int) -> dict:
    """The byte models' figure for every cut and jacobian tag of one step
    at ``rows`` rows a cut (serial: one microbatch)."""
    v, D, K = cfg.vertical, cfg.d_model, cfg.vertical.num_clients
    plain = costs.cut_bytes(rows, D)
    if fanout is not None:
        from repro_torch.runtime.topology import AggTree

        per = costs.tree_cut_bytes(AggTree(K, fanout=fanout), plain)
        return {**{f"tree_cut[{lvl}]": b
                   for lvl, b in per["cut_bytes_per_level"].items()},
                **{f"tree_jac[{lvl}]": b
                   for lvl, b in per["jac_bytes_per_level"].items()}}
    if v.compression is not None:
        one = costs.wire_bytes((rows, D), 4, v.compression, v.topk_fraction)
        return {**{f"compressed_cut[{k}]": one for k in range(K)},
                **{f"compressed_jac[{k}]": one for k in range(K)}}
    return {**{f"masked_cut[{k}]": costs.masked_cut_bytes(rows, D)
               for k in range(K)}, **{f"jac[{k}]": plain for k in range(K)}}


def expect_wire_bytes(label: str, ledgers: list, want: dict) -> None:
    for step, ledger in enumerate(ledgers):
        got = {tag: ledger.bytes_with_tag(tag) for tag in want}
        if got != want:
            raise AssertionError(f"{label} step {step}: ledger {got} != "
                                 f"costs {want}")


def overlay_run(cfg, fanout, steps: int, transport: str, **kw) -> tuple:
    """One ``train_split`` run with the merges it made; returns (out,
    metrics, seconds, launches, merges)."""
    with merge_calls() as merges:
        out, metrics, seconds, launches, _ = train(
            cfg, steps, "cuda", transport=transport,
            agg_tree_fanout=fanout, **kw)
    return out, metrics, seconds, launches, merges


def expect_overlay_merges(label, merges, launches, steps, strategy,
                          shape) -> None:
    expect_launches(launches, {"merge_reduce_kernel": steps,
                               "merge_reduce_bwd_kernel": steps})
    if merges != [(strategy, shape)] * steps:
        raise AssertionError(f"{label}: role 0 merged {merges}, expected "
                             f"{steps} x {(strategy, shape)}")


def overlay_small_card_vs_card() -> dict:
    """(a) Reduced smollm-360m at K = 4 on the card, every overlay, 3 steps
    over the inline transport against 3 over threads.  Returns the
    launches."""
    base = get_arch("smollm-360m").reduced()
    total: dict = {}
    for overlay in OVERLAYS:
        cfg, fanout = overlay_cfg(base, overlay)
        strategy, K = ("sum", 2) if fanout else ("avg", OVERLAY_K)
        shape = (K, TRAIN_BATCH * TRAIN_SEQ, cfg.d_model)
        runs = {}
        for transport in ("sim", "inproc"):
            out, metrics, _, launches, merges = overlay_run(
                cfg, fanout, OVERLAY_STEPS, transport,
                print_fn=lambda *a: None)
            expect_overlay_merges(f"overlay {overlay} {transport}", merges,
                                  launches, OVERLAY_STEPS, strategy, shape)
            expect_wire_bytes(f"overlay {overlay} {transport}",
                              metrics.ledgers, overlay_wire_bytes(
                                  cfg, fanout, TRAIN_BATCH * TRAIN_SEQ))
            if cfg.vertical.secure_aggregation and \
                    metrics.keyx_ledger.total() != \
                    costs.key_exchange_bytes(OVERLAY_K)["total"]:
                raise AssertionError(f"overlay {overlay}: key exchange "
                                     f"{metrics.keyx_ledger.total()} bytes")
            runs[transport] = (out, metrics)
            for name, n in launches.items():
                total[name] = total.get(name, 0) + n
        (out, metrics), (iout, imetrics) = runs["sim"], runs["inproc"]
        tol = MASKED_TOL if cfg.vertical.secure_aggregation else 0.0
        loss_diff = max(abs(a - b) for a, b in zip(metrics.losses,
                                                   imetrics.losses))
        worst = max(float((a - b).abs().max()) for a, b in zip(
            _leaves(out), _leaves(iout)))
        if loss_diff > tol or worst > tol:
            raise AssertionError(f"overlay {overlay}: sim vs inproc losses "
                                 f"{loss_diff:.3e}, params {worst:.3e} > "
                                 f"{tol}")
        if [by_route(x) for x in metrics.ledgers] != \
                [by_route(x) for x in imetrics.ledgers]:
            raise AssertionError(f"overlay {overlay}: sim and inproc "
                                 "ledgers differ")
        log(f"overlay small {overlay}: reduced smollm-360m K={OVERLAY_K} "
            f"on the card, {OVERLAY_STEPS} steps of {TRAIN_BATCH} x "
            f"{TRAIN_SEQ}: sim vs inproc losses max |diff| {loss_diff:.3e}, "
            f"params {worst:.3e} (<= {tol}); step-0 max |dgrad| "
            f"{metrics.step0_max_dgrad:.3e}; ledgers equal and equal to "
            f"costs ({metrics.ledgers[0].total()} bytes a step); merges "
            f"{strategy} {shape} one each way a step")
    return total


def overlay_full(card: str, overlay: str, atol: float) -> tuple:
    """Full-width smollm-360m under ``overlay`` over four spawned
    processes on the card, 5 serial steps: step 0 verified at ``atol``,
    the byte models' figures every step, one merge each way a step.
    Returns (cfg, metrics, launches)."""
    cfg, fanout = overlay_cfg(get_arch("smollm-360m"), overlay)
    strategy, K = ("sum", 2) if fanout else ("avg", OVERLAY_K)
    torch.cuda.empty_cache()
    with payload_sync_time() as spent:
        _, metrics, seconds, launches, merges = overlay_run(
            cfg, fanout, TRAIN_STEPS, "multiproc")
    expect_overlay_merges(f"overlay {overlay} full", merges, launches,
                          TRAIN_STEPS, strategy,
                          (K, TRAIN_BATCH * TRAIN_SEQ, cfg.d_model))
    want = overlay_wire_bytes(cfg, fanout, TRAIN_BATCH * TRAIN_SEQ)
    expect_wire_bytes(f"overlay {overlay} full", metrics.ledgers, want)
    if metrics.step0_max_dgrad is None or metrics.step0_max_dgrad > atol:
        raise AssertionError(f"overlay {overlay} full: step 0 not verified "
                             f"at {atol} ({metrics.step0_max_dgrad})")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = metrics.step_times[1:]
    rate = len(steady) * tokens / sum(steady)
    log(f"overlay {overlay} full: {cfg.name} full width, K={OVERLAY_K} "
        f"spawned processes on the card, {TRAIN_STEPS} steps of {tokens} "
        f"tokens, losses {metrics.losses}, step-0 max |dgrad| vs "
        f"protocol_step {metrics.step0_max_dgrad:.3e} (<= {atol:g}); bytes "
        f"a step {want} (= costs); launches {launches}; merges "
        f"{merges[0]} x {len(merges)} | {card}")
    log(f"overlay {overlay} full: {rate:.1f} train tokens/s over steps 1-"
        f"{TRAIN_STEPS - 1} (step times {metrics.step_times} s) vs "
        f"{MEASURED.get('multiproc_train_tokens_s', 0.0):.1f} plain over "
        f"processes (phase 14, this run); spawn and connect "
        f"{metrics.setup_s:.2f} s; wall {seconds:.4f} s; role 0 spent "
        f"{spent['s']:.4f} s in {spent['calls']} payload_bytes calls (a "
        f"device sync each, which also waits for the work queued before "
        f"it) | {card}")
    return cfg, metrics, launches


def overlay_phase(card: str) -> dict:
    """Phase 15; returns the launches of its in-process runs, and under
    "tree" those at the full-width tree's stack, ``TREE_SHAPE``."""
    t0 = time.perf_counter()
    LAUNCH_DIR.mkdir(parents=True, exist_ok=True)
    total = overlay_small_card_vs_card()
    from repro_torch.core.compression import STEP0_VERIFY_ATOL

    rows = TRAIN_BATCH * TRAIN_SEQ
    cfg, topk, launches = overlay_full(card, "topk", STEP0_VERIFY_ATOL)
    up = sum(topk.ledgers[0].bytes_with_tag(f"compressed_cut[{k}]")
             for k in range(OVERLAY_K))
    down = sum(topk.ledgers[0].bytes_with_tag(f"compressed_jac[{k}]")
               for k in range(OVERLAY_K))
    want = OVERLAY_K * costs.wire_bytes((rows, cfg.d_model), 4, "topk",
                                        TOPK_FRACTION)
    if (up, down) != (want, want):
        raise AssertionError(f"overlay topk full: {up} up, {down} down, "
                             f"costs {want}")
    log(f"overlay topk full: {up} bytes up and {down} down a step "
        f"(costs.wire_bytes x {OVERLAY_K}; plain "
        f"{OVERLAY_K * costs.cut_bytes(rows, cfg.d_model)})")
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n
    cfg, secure, launches = overlay_full(card, "secure+tree", MASKED_TOL)
    keyx = secure.keyx_ledger.total()
    if keyx != costs.key_exchange_bytes(OVERLAY_K)["total"] or keyx != 1320:
        raise AssertionError(f"overlay secure+tree full: key exchange "
                             f"{keyx} bytes")
    if any(ledger.bytes_with_tag(f"keyx_pub[{k}]")
           for ledger in secure.ledgers for k in range(OVERLAY_K)):
        raise AssertionError("overlay secure+tree full: a step re-ran the "
                             "key exchange")
    if secure.step0_mask_residue is None or \
            secure.step0_mask_residue > secure.step0_mask_bound:
        raise AssertionError(f"overlay secure+tree full: mask residue "
                             f"{secure.step0_mask_residue} > bound "
                             f"{secure.step0_mask_bound}")
    role0 = secure.ledgers[0].bytes_with_tag("tree_cut[0]")
    star = OVERLAY_K * costs.masked_cut_bytes(rows, cfg.d_model)
    log(f"overlay secure+tree full: key exchange {keyx} bytes, once; "
        f"step-0 masked sum at role 0 vs the raw sum max |residue| "
        f"{secure.step0_mask_residue:.3e} <= cancellation_bound "
        f"{secure.step0_mask_bound:.3e}; role 0 receives {role0} cut "
        f"bytes a step where the star's receives {star}")
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n
    total["tree"] = launches["merge_reduce_kernel"]
    summary = launch_cli(
        card, ("--compress", "int8"),
        "step-0 compressed-wire verification vs protocol_step")
    if summary["compress"] != "int8":
        raise AssertionError(f"launcher --compress int8: summary {summary}")
    log(f"overlay: phase 15 took {time.perf_counter() - t0:.1f} s; "
        f"launches {total}")
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this script needs one CUDA card")
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    build_library()
    worst = check_kernels()
    worst.update(check_backward_kernels())
    check_concat_edges()
    check_reduce_bwd_edges()
    rows = time_path_shapes(card)
    rows.update(time_backward_shapes(card))
    time_merge_host(rows, card)
    check_small_against_cpu()
    launches = serve_full(card)
    train_small_against_cpu()
    launches.update(train_full(card))
    flash_worst = check_flash_kernel()
    flash_rows = time_flash(card)
    check_small_long_against_cpu()
    flash_launches = {64: serve_long(card)}
    ssd_worst = check_ssd_kernel()
    ssd_rows, timed_worst = time_ssd(card)
    ssd_worst = max(ssd_worst, timed_worst)
    ssd_bwd_worst = check_ssd_bwd_kernel()
    ssd_bwd_rows = time_ssd_bwd(card)
    check_small_ssm_against_cpu()
    check_small_ssm_bf16_against_cpu(card)
    launches["ssd_chunk_kernel"] = ssm_full(card)
    check_small_long_against_cpu(SC_ARCH, head_dim=128)
    flash_launches[128] = serve_starcoder(card)
    mlp_launches = mlp_phase(card)
    nowait_launches, nowait_shape_launches = nowait_phase(card)
    ssm_train = ssm_train_phase(card)
    flash_launches[64] += mono_phase(card)
    launch_launches = launch_phase(card)
    overlay_launches = overlay_phase(card)

    kernels = []
    for name, strategy, shape, replaces in (
            ("merge_reduce_kernel", "avg", (4, 1024, 960),
             "src/repro/kernels/merge_pool.py:29"),
            ("merge_concat_kernel", "concat", (4, 1024, 240),
             "src/repro/kernels/merge_pool.py:67"),
            ("merge_reduce_bwd_kernel", "avg", TRAIN_SHAPE,
             "src/repro/kernels/merge_pool.py:144"),
            ("merge_concat_bwd_kernel", "concat", CONCAT_TRAIN_SHAPE,
             "src/repro/kernels/merge_pool.py:96")):
        row = rows[(name, strategy, shape)]
        entry = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/merge_pool.cu",
            "replaces": replaces,
            "launches": (launches[name] + mlp_launches[name]
                         + nowait_launches[name] + ssm_train.get(name, 0)
                         + launch_launches.get(name, 0)
                         + overlay_launches.get(name, 0)),
            "max_abs_err": worst[name],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"],
            "plain_device_ms": row["plain_device_ms"],
            "library_device_ms": row["library_device_ms"],
            "shape": list(shape), "dtype": "float32"}
        for key in ("host_us", "library_reshape_ms",
                    "library_reshape_device_ms", "library_two_call_ms",
                    "library_two_call_device_ms"):
            if key in row:
                entry[key] = row[key]
        # the MLP path's shapes (phases 10 and 11), the no-wait LM stack
        # (phase 11), the ssm training stack (phase 12) and the tree's
        # top-level stack (phase 15), whose launches are in the count
        entry["shapes"] = [
            {"strategy": s, "shape": list(sh), "dtype": "float32",
             "library_ms": None, **rows[(name, s, sh)]}
            for s, sh in MLP_TIME_SHAPES + NOWAIT_TIME_SHAPES
            + SSM_TRAIN_TIME_SHAPES + TREE_TIME_SHAPES
            if (name, s, sh) in rows]
        for sub in entry["shapes"]:
            if tuple(sub["shape"]) == NOWAIT_SHAPE:
                sub["launches"] = nowait_shape_launches
            if tuple(sub["shape"]) == SSM_TRAIN_SHAPE:
                sub["launches"] = ssm_train["full"][name]
            if tuple(sub["shape"]) == TREE_SHAPE:
                # role 0's launches at the tree's stacks (full width at
                # this shape, reduced width at (2, 2048, 256))
                sub["launches"] = overlay_launches["tree"]
        kernels.append(entry)
    def flash_entry(shape, launched=None):
        """The kernel's row at a timed shape; ``launched`` is its count on
        a main path (a head dim on no path has none)."""
        row = flash_rows[shape]
        B, H, Hkv, S, D = shape
        entry = {
            "name": flash_name(D), "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:27",
            "launches": launched, "max_abs_err": flash_worst[D],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "fma_bound_ms": row["fma_bound_ms"],
            "library_ms": row["library_ms"], "device_ms": row["device_ms"],
            "plain_device_ms": row["plain_device_ms"],
            "library_device_ms": row["library_device_ms"],
            "shape": [B, H, S, D], "kv_heads": Hkv, "causal": True,
            "dtype": "float32"}
        if launched is None:
            del entry["launches"]
        return entry

    # the flash kernel by head dim: 64 on phase 6's path, 128 on phase 9's;
    # 80 and 112 are on no path yet, so they ride in the D = 128 entry
    kernels.append(flash_entry((1, 15, 5, 32768, 64), flash_launches[64]))
    wide = flash_entry((1, 24, 2, 32768, 128), flash_launches[128])
    wide["off_path_head_dims"] = [flash_entry(shape)
                                  for shape in FLASH_WIDE_SHAPES
                                  if shape[4] in (80, 112)]
    kernels.append(wide)
    def ssd_entry(shape):
        row = ssd_rows[shape]
        return {
            "name": "ssd_chunk_kernel", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:23",
            "launches": launches["ssd_chunk_kernel"]
            + ssm_train["ssd_chunk_kernel"]
            + launch_launches.get("ssd_chunk_kernel", 0),
            "max_abs_err": ssd_worst, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "fma_bound_ms": row["fma_bound_ms"],
            "library_ms": None, "device_ms": row["device_ms"],
            "plain_device_ms": row["plain_device_ms"],
            "heads_per_block": row["plan"]["heads"],
            "blocks": row["plan"]["blocks"], "shape": list(shape[:4]),
            "d_state": shape[4], "chunk": shape[5], "dtype": "float32"}

    # the server shape at 32768 tokens; the other timed shapes ride in it
    # (their launches are in its count)
    ssd_row = ssd_entry(SSD_TIME_SHAPES[1])
    ssd_row["other_shapes"] = [ssd_entry(shape) for shape in SSD_TIME_SHAPES
                               if shape != SSD_TIME_SHAPES[1]]
    for entry in ssd_row["other_shapes"]:
        del entry["launches"]
    kernels.append(ssd_row)

    def ssd_bwd_entry(shape):
        row = ssd_bwd_rows[shape]
        return {
            "name": "ssd_chunk_bwd_kernel", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
            # the gradient of that kernel's function: the JAX package has
            # no backward kernel (jax.grad of its plain chunked scan)
            "replaces": "src/repro/kernels/ssd_scan.py:23",
            "launches": ssm_train["ssd_chunk_bwd_kernel"]
            + launch_launches.get("ssd_chunk_bwd_kernel", 0),
            "max_abs_err": row["max_abs_err"],
            "max_err_over_largest_entry": ssd_bwd_worst,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "device_ms": row["device_ms"],
            "plain_device_ms": row["plain_device_ms"],
            "f32_fma_ms": row["fma_ms"],
            "second_kernel": "ssd_chunk_bwd_reduce_kernel (the sum of dB "
                             "and dC over the head groups, launched with it "
                             "and timed with it)",
            "shape": list(shape[:4]), "d_state": shape[4],
            "chunk": shape[5], "dtype": "float32"}

    # the server shape of phase 12; the towers' rides in it (its launches
    # are in the count)
    bwd_row = ssd_bwd_entry(SSD_BWD_SHAPES[0])
    bwd_row["other_shapes"] = [ssd_bwd_entry(SSD_BWD_SHAPES[1])]
    del bwd_row["other_shapes"][0]["launches"]
    kernels.append(bwd_row)
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
