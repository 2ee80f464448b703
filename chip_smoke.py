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
the inline, threaded and process transports and through the launcher,
and the other dense configs and the hybrid family: long-prompt split
serving of full-width stablelm-3b (f32, head dim 80) and qwen3-32b (bf16,
qk-norm), and full-width zamba2-7b's forward, generate and split
training (Mamba2 super-blocks with a weight-shared attention block),
and the moe family: full-width deepseek-moe-16b's forward, generate and
split training with the router's aux loss on the protocol's slot,
arctic-480b at published widths in bf16, and the compact bilinear
merge, and the audio and vlm families: full-width whisper-tiny's
forward, cross prefill and decode and its split training over mel-band
towers, full-width internvl2-26b's forward in bf16, vision prefill and
decode, and its split training through the sequence-concat merge, and
training past 2048 tokens: the hand-written flash backward kernels
(CUDA C++, 3xTF32 wgmma) behind a differentiable attention, a monolithic
step and split training of full-width smollm-360m at 4096 tokens.

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
6. Long-prompt split serving: full-width smollm-360m cut to 8 of its 32
   layers, K = 4, 4 slots, greedy, prompts of 2500-32768 tokens plus one
   of 1024 (dense branch) in one batch.  Launch counters reset just
   before the run, read just after: 14 flash launches per prompt past
   2048 tokens (6 server + 4 x 2 tower layers) and one merge launch per
   merge.  A plain run (merge and attention, role 0 and towers) gives
   identical tokens and prefill logits within 1e-3, launching no kernel;
   the reduced model on the card matches the CPU path on a 2304-token
   prompt (logits 1e-4, tokens).
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
   (``make_split_train_step``, AdamW 3e-3, batch 256, 200 of its 400
   steps over
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
   prefill tokens/s and peak memory.  (c) A ring cache of 160 slots
   under window 160, 4 x 128 prompt tokens and 160 new, gives the tokens
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
16. The other dense configs and the hybrid family, counters reset just
   before each run and read just after.  (a) Reduced stablelm-3b,
   qwen3-32b (qk-norm) and zamba2-7b at ``shared_attn_every`` 2 over 6
   layers (2 super-blocks and a tail; head dim 112), same weights, card
   against CPU: ``forward`` logits within 1e-4 (zamba2 over 2304 tokens:
   7 SSD and 2 flash launches at D 112) and greedy ``generate`` tokens
   identical; stablelm at head dim 80 and qwen3 at 128 served split on a
   2304-token prompt, as phase 6 serves smollm.  (b) Full-width
   stablelm-3b (f32, seeded weights; 32 / 32 heads of 80), K = 4, two
   slots: 4 short requests and prompts of 2500 and 8192 tokens, each long
   prefill timed alone; 38 flash launches at D = 80 per long prompt (30
   server + 4 x 2 tower layers), one merge launch per merge, the ledger =
   the cost model; a plain run (merge and attention) gives identical
   tokens and prefill logits within 1e-3.  (c) Full-width qwen3-32b in
   bf16 (32.2 B params, 64.5 GB; every stacked weight drawn layer by
   layer, so no f32 copy of a stack is held), K = 4: one 4096-token
   prompt and 3 short ones, 8 new tokens each: 70 flash launches at
   D = 128, every one in bf16 (62 server + 4 x 2 tower layers), the
   ledger = the cost model at 2 bytes a cut element, peak memory.  (d)
   Full-width zamba2-7b (f32, seeded; 13 super-blocks of 6 Mamba2 layers
   and a tail of 1, K = 4 Mamba2 towers of width 896): ``make_prefill``
   at 8192 and 32768 tokens, 87 SSD launches (79 server + 4 x 2 tower
   layers) and 13 flash launches at D = 112 each; at 8192 the plain
   forward launches nothing and its logits agree within 1e-3; greedy
   ``generate`` of 2 x 64 prompt tokens and 16 new, the first tokens the
   forward's argmax.  (e) zamba2-7b at full width cut to 15 layers (2
   super-blocks and a tail of 1), ``train_split`` over inproc, 3 serial
   steps of 8 x 256, step 0 verified at 1e-5: per step 13 server and
   2 x 8 tower SSD forward launches, 21 backward, one avg merge each way
   at (4, 2048, 3584) (held and timed in phase 2), the ledger = the byte
   models; train tokens/s and peak memory.  Phase 5 also holds and
   times flash at qwen3-32b's (64 / 8) and (16 / 2) heads of 128 at 4096
   tokens in bf16, phase 7 both SSD kernels at zamba2-7b's (1, 8192) and
   (8, 256) tokens with 112 and 28 heads and d_state 64.
17. The moe family, counters reset just before each run and read just
   after.  Top-k routing is discontinuous (two runs' roundings may tip a
   near-tie), so the run held against another replays its routes
   (``models/moe.route`` wrapped: the same experts, gates from its own
   probs) and every token is held; it prints the (token, layer) pairs
   whose own expert set would have differed, and its router probs stay
   within 5e-5 (f32; 4e-3 in bf16) of the other run's.  (a) Reduced
   deepseek-moe-16b split and centralized (its dense first layer) and
   reduced arctic-480b (a dense residual), same weights, card against
   CPU: logits within 1e-4, aux within 1e-6, greedy ``generate`` tokens
   identical.  (b)
   Full-width deepseek-moe-16b (f32, seeded; 15.7 B params, 62.9 GB), K =
   4: ``forward`` of 4096 tokens, 34 flash launches at D = 128 (26 server
   at 16 / 16 heads, 4 x 2 tower at 4 / 4), against the plain path within
   1e-3 (phase 13's prefill tolerance), the aux within the limit the
   probs' difference sets, the peak printed; greedy ``generate`` of 2 x
   32 prompt tokens and 8 new at the real capacity and at capacity factor
   100, where nothing is dropped and the tokens equal the argmax of a
   teacher-forced plain forward that replays decode's routes (at least
   12 of 16 held).  (c)
   deepseek-moe-16b at full width cut to 6 layers (2 tower, 4 MoE server
   layers; 2.79 B params, AdamW in place), ``train_split`` over inproc, 3
   serial steps of 8 x 256, step 0 verified at 1e-5: avg (4, 2048, 2048)
   once each way a step on the merge kernels, the ledger = the byte
   models with 4 bytes of aux a step, the peak printed.  (d)
   arctic-480b at published widths cut to 4 layers, bf16
   (27.9 B params, 55.7 GB; the init holds no f32 expert stack):
   ``forward`` of 4096 tokens, 10 flash launches at D = 128 in bf16 (2
   server at 56 / 8 heads, 4 x 2 tower at 14 / 2), against the plain
   path as phase 16 (c) holds qwen3-32b's.  (e) ``merge_cbp`` of (4,
   2048, 960) into 2048 features with a client dropped, card against CPU
   within 1e-5 of the largest entry.  Phase 5 also holds and times flash
   at deepseek's (16 / 16), (4 / 4) heads in f32 and arctic's (56 / 8),
   (14 / 2) in bf16, at 4096 tokens.
18. The audio and vlm families, counters reset just before each run and
   read just after.  (a) Reduced whisper-tiny and internvl2-26b, same
   weights, card against CPU: ``forward`` logits and the modality
   prefill (``prefill_cross_attention``, ``prefill_vision``) plus 4
   ``decode_step``s within 1e-4, no launch; 2 ``train_split`` steps over
   inproc on each, step 0 verified at 1e-5 in each, losses and final
   params within 1e-4.  (b) Full-width whisper-tiny (f32, seeded; 55.7 M
   params): ``forward`` of 8 x (1500 frames, 448 tokens), no launch (no
   attention reaches 2048 x 2048); ``prefill_cross_attention`` and 448
   teacher-forced ``decode_step``s, each within 2e-3 of the forward's
   logits (the JAX package's decode-equivalence tolerance), then 32
   greedy tokens; tokens/s and the peak printed.  (c) whisper-tiny split
   training, K = 2 mel-band towers, avg, ``train_split`` over inproc, 5
   serial steps of 8 x 448, role 0's server taking the batch's tokens,
   step 0 verified at 1e-5: avg (2, 12000, 384) once each way a step on
   the merge kernels, the ledger = the byte models.  (d) Full-width
   internvl2-26b in bf16 (20.25 B params, 40.5 GB): ``forward`` of 1024
   patches and 3072 text tokens, 48 flash launches at D = 128 in bf16 (47
   server layers at 4096, 48 q / 8 kv heads, and the text tower at 3072
   from position 1024), against the plain path as phase 16 (c) holds
   qwen3-32b's; ``prefill_vision``, 64 text tokens replayed (each step
   within 2^-4 of the forward's largest logit there) and 16 greedy.  (e)
   internvl2-26b cut to 4 layers (3.09 B params, f32), ``train_split``
   over inproc, 3 serial steps of 4 x (1024 patches + 256 text tokens),
   the cuts merged by the program's sequence concatenation (no kernel),
   step 0 verified at 1e-5, the ledger = the byte models.  Phase 2 also
   holds and times the merge kernels at (2, 12000, 384), phase 5 flash
   at (48 / 8, 4096) and (48 / 8, 3072), D = 128, in bf16.
19. Training past 2048 tokens.  (a) The flash backward's four kernels
   (``flash_attention_bwd_preprocess_kernel``, ``_dkdv_kernel``,
   ``_reduce_kernel``, ``_dq_kernel``, built with the library in phase 2;
   their ptxas reports printed, a spill or a C7511, C7512, C7515 or C7520
   note fails, and so does an instantiation of dkdv or dq without HGMMA in
   its SASS; the launch plan printed at the training shapes) at every
   instantiation, D 32-128 x
   f32 / bf16, at (1, 6 q / 2 kv, 2304, D), causal and full, against
   ``ref.flash_attention_bwd`` on the forward kernel's output and
   logsumexp: f32 dq, dk and dv within 1e-4 of each gradient's largest
   plain entry, bf16 within 2e-2; the forward's logsumexp within 1e-4 of
   ``ref.flash_attention_lse``; two launches bit-identical (f32 and
   bf16).  Timed at smollm-360m's training shapes, server (2, 15 / 5,
   4096, 64) and towers (2, 3 / 1, 4096, 64): the kernels per call and
   on the device, the plain backward, SDPA's memory-efficient backward
   (kv heads repeated) per call and on the device, the bound (10 D flops
   per attended pair at 3xTF32, the design's 7-product floor and the
   f32-FMA figure beside), and the forward with and
   without its logsumexp there and at (1, 15 / 5, 32768, 64).  (b)
   Full-width smollm-360m cut to 4 layers (2 tower + 2 server), one
   ``make_train_step`` at 1 x 4096 on the kernels against
   ``use_kernel=False`` (the plain chunked attention under autograd):
   every gradient leaf within 1e-3 of its largest plain entry, 10 flash
   forward and 10 backward launches, both peaks printed.  (c)
   Full-width smollm-360m ``train_split`` K = 4 avg over threads, 3
   serial steps of 2 x 4096, step 0 verified against ``protocol_step``
   at 1e-5, exact launches (46 flash forward and 38 backward a pass: the
   feature holders run their towers' forward again under grad in their
   backward; 4 passes with the verification), train tokens/s and peak
   memory.  (d)
   ``python -m repro_torch.launch.train --seq 4096 --batch 2 --steps 2
   --transport inproc`` exits 0 with its step-0 line.

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
from repro_torch.data.loader import LMBatchLoader, to_tensor  # noqa: E402
from repro_torch.core import bilinear, costs, dropping, protocol  # noqa: E402
from repro_torch.core import split_model, towers  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import merge_pool as mp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import backbone, frontend, mamba  # noqa: E402
from repro_torch.models import split_program  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
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
# smollm-360m cut to 8 of its 32 layers (6 server + 2 tower): the plain
# run's chunked attention over the 16384- and 32768-token prompts took
# ~90% of the phase at full depth (82-94 s on an NVIDIA H100 80GB HBM3);
# 16 layers until phase 19 was added, 47 s of plain run then
LONG_LAYERS = 8
LONG_CUT_CACHE_BYTES = 256 * 2 ** 20
# the flash kernel against the plain version, as (rtol, atol): in f32
# against the plain f32 output; in bf16 against the plain version's f32
# output from the same bf16 inputs.  Both compute in f32 and the kernel
# rounds its output to bf16, so a bf16 element may be off by half a bf16
# ulp (2^-9 to 2^-8 of its size) beside the f32 path's own error (worst
# 3.2e-05 at the shapes below); a kernel off by a percent of an output
# fails it at every shape.  The S = 4096 outputs are ~0.026 in size.
FLASH_TOL = {torch.float32: (5e-4, 5e-4), torch.bfloat16: (2 ** -7, 1e-4)}
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
# qwen3-32b's server (64 q / 8 kv heads) and towers (16 / 2) at D 128 at
# its 4096-token prompt, checked in f32 and bf16 and timed in bf16, as
# phase 16 serves it
FLASH_QWEN_SHAPES = [(1, 64, 8, 4096, 128), (1, 16, 2, 4096, 128)]
# phase 17's: deepseek-moe-16b's server (16 / 16) and towers (4 / 4) at
# its 4096-token forward in f32, arctic-480b's server (56 / 8, a group of
# 7) and towers (14 / 2) in bf16; checked in both dtypes, timed in the
# dtype the path runs
FLASH_MOE_F32 = [(1, 16, 16, 4096, 128), (1, 4, 4, 4096, 128)]
FLASH_MOE_BF16 = [(1, 56, 8, 4096, 128), (1, 14, 2, 4096, 128)]
H100_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores, H100 SXM
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
# zamba2-7b's Mamba2 layers (d_state 64): the server's 112 heads and the
# towers' 28 (d_model 3584 / 4 = 896, d_inner 1792) at phase 16's 8192-token
# forward and its 8 x 256 training steps; head counts that are not powers
# of two, checked and timed both ways
ZAMBA_SSD_SHAPES = [(1, 8192, 112, 64, 64, 128), (1, 8192, 28, 64, 64, 128),
                    (8, 256, 112, 64, 64, 128), (8, 256, 28, 64, 64, 128)]
SSD_SHAPES += ZAMBA_SSD_SHAPES
# the SSD backward kernel (phase 7) at phase 12's training shapes: 8 x 256
# tokens through the server (64 heads) and the towers (16), the reduced
# config's server and towers (Q 32, N 16; phase 12 (a)), one chunk per
# sequence (S = Q), a last head group partly filled (201 heads: HG 2 on
# 132 SMs) and P 32; each gradient within 1e-4 of the plain one's largest
# entry (3xTF32 against PyTorch's f32 products, summed in other orders)
SSD_BWD_SHAPES = [(8, 256, 64, 64, 128, 128), (8, 256, 16, 64, 128, 128),
                  (8, 256, 8, 64, 16, 32), (8, 256, 4, 64, 16, 32),
                  (8, 128, 64, 64, 128, 128), (1, 128, 201, 32, 128, 128),
                  (2, 256, 24, 32, 128, 128)] + ZAMBA_SSD_SHAPES
SSD_BWD_REL = 1e-4
SSD_BWD_NEG_A = -80.0  # a per step: exp above the diagonal would overflow
# the ssm training slice (phase 12): mamba2-1.3b's cut stack at 8 x 256
# tokens, where its merges run the reduce kernels both ways
SSM_TRAIN_SHAPE = (4, 2048, 2048)
SSM_TRAIN_TIME_SHAPES = [("avg", SSM_TRAIN_SHAPE)]
# timed: the server shape at 8192 and 32768 tokens, the tower's at 32768
SSD_TIME_SHAPES = [(1, 8192, 64, 64, 128, 128), (1, 32768, 64, 64, 128, 128),
                   (1, 32768, 16, 64, 128, 128)] + ZAMBA_SSD_SHAPES
# the backward, timed: phase 12's server and tower shapes, then zamba2-7b's
SSD_BWD_TIME_SHAPES = SSD_BWD_SHAPES[:2] + ZAMBA_SSD_SHAPES
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
# the paper MLP slice: the paper tables' loop (AdamW 3e-3, batch 256; 200
# of its 400 steps, cut to keep the script's time) on the three datasets
# at their published widths; the Executor
# run on PhraseBank (plain SGD at 0.1 in the towers and the server)
MLP_MERGES = ("max", "avg", "concat", "mul", "sum")
MLP_LR, MLP_BATCH, MLP_STEPS, MLP_CHECK_STEPS = 3e-3, 256, 200, 5
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
# 4096 (past the flash threshold), 32 new tokens each; a ring cache of 160
# slots against a linear one under the same window (128 + 160 positions,
# so 128 of them past the wrap); int8 KV with 4
# flash-decoding chunks against f32 over 64 decode steps (the JAX
# package's bounds, tests/test_kv_quant.py); the throughput probe at a
# linear cache of 4096 and at the ring of cfg.sliding_window, which is
# the JAX package's decode_cache_plan for prompts past 65536 tokens
MONO_SHORT, MONO_LONG, MONO_NEW = (8, 128), 4096, 32
MONO_RING_BATCH, MONO_RING_PROMPT, MONO_RING = 4, 128, 160
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
# the other dense configs and the hybrid family (phase 16): stablelm-3b
# (f32, head dim 80) serves 4 short requests beside prompts of 2500 and
# 8192 tokens, qwen3-32b (bf16: 129 GB in f32) one prompt of 4096 beside 3
# short ones; zamba2-7b's forward at 8192 and 32768 tokens, generate of 2
# x 64 prompt tokens, and split training at 15 of its 81 layers (AdamW
# over all 81 in f32 would need 106 GB), whose cut stack (4, 2048, 3584)
# the reduce kernels merge both ways
SL_ARCH, QW_ARCH, HY_ARCH = "stablelm-3b", "qwen3-32b", "zamba2-7b"
SL_PROMPTS, SL_NEW = [2500, 64, 8192, 200, 512, 96], [8, 16, 8, 12, 8, 10]
QW_PROMPTS, QW_NEW = [4096, 64, 200, 512], [8, 8, 8, 8]
HY_FORWARDS = [(1, 8192), (1, 32768)]
HY_GEN = (2, 64), 16
HY_TRAIN_LAYERS, HY_TRAIN_STEPS = 15, 3
HYBRID_TRAIN_SHAPE = (4, 2048, 3584)
HYBRID_TRAIN_TIME_SHAPES = [("avg", HYBRID_TRAIN_SHAPE)]
# phase 16 (c)'s bf16 kernel run against its plain one: logits within
# 2^-4 of the step's largest.  The two runs' attentions agree to f32 and
# round to bf16; from the first output that rounds the other way their
# roundings part, and each of 64 bf16 layers adds its own (2^-9 of an
# element, ~1% after 64 layers): 2.0e-2 of the largest logit at the
# 4096-token prefill on an NVIDIA H100 80GB HBM3.  A kernel off by a
# percent of its outputs is held by phase 5 (rtol 2^-7 at these shapes);
# one that is wrong moves the logits by their spread
PLAIN_BF16_TOL = 2 ** -4
# the moe family (phase 17): deepseek-moe-16b's and arctic-480b's forward at
# 4096 tokens (kernel against plain), deepseek's generate of 2 x 32 prompt
# tokens and 8 new, its split training cut to 6 layers (2 tower + 4 MoE
# server layers, 2.79 B params; AdamW updates in place, about 4x the param
# bytes at its update, where an out-of-place update holds 8x and ran out
# of the card's 80 GB at 5 and 6 layers), whose
# cut stack (4, 2048, 2048) the reduce kernels merge both ways
# (phase 12's ssm stack, the same shape), arctic cut to 4 layers in
# bf16 (55.7 GB: the deepest cut at published widths that fits), and the
# compact bilinear merge of (4, 2048, 960) into 2048 features
DS_ARCH, AR_ARCH = "deepseek-moe-16b", "arctic-480b"
MOE_PREFILL = 4096
MOE_GEN = (2, 32), 8
MOE_NO_DROP = 100.0  # the capacity factor at which decode drops nothing
# of its 2 x 8 generated tokens, at least this many are held against the
# teacher-forced forward (those whose top-2 logit gap is above 2e-3)
MOE_GEN_HELD = 12
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 6, 3
MOE_TRAIN_SHAPE = SSM_TRAIN_SHAPE
AR_LAYERS = 4
CBP_SHAPE, CBP_OUT = (4, 2048, 960), 2048
# below this share of its row's largest, an element's sketch product is
# near the signed square root's singular point (see cbp_against_cpu)
CBP_ROOT_FLOOR = 1e-3
# phase 17's plain runs replay the kernel runs' routes; the router probs of
# the two may differ by this much, the roundings of every layer before the
# router.  Read on an NVIDIA H100 80GB HBM3: f32 1.369e-05 (deepseek-moe-16b
# at 4096 tokens, attention kernel against plain; card against CPU at the
# reduced widths <= 6.3e-07); bf16 1.722e-03 (arctic-480b, whose router
# inputs are bf16: a rounding there is 2^-8 of the input)
ROUTER_TOL = {torch.float32: 5e-5, torch.bfloat16: 4e-3}
# the audio and vlm families (phase 18): whisper-tiny (f32) forward over 8
# x (1500 frames, 448 tokens: its 30 s window and its text context), its
# cross prefill and 448 teacher-forced decode steps (within 2e-3 of the
# forward's logits: the JAX package's tests/test_decode_equiv.py rule),
# then 32 greedy tokens; its split training (K = 2 mel-band towers, avg)
# at 8 x 448, 5 steps, whose cut stack (2, 12000, 384) the reduce kernels
# merge both ways.  internvl2-26b at full width in bf16 (40.5 GB; 81 GB
# in f32): one prompt of 1024 patches and 3072 text tokens, 48 flash
# launches at D = 128 with 48 q / 8 kv heads (47 server layers at 4096,
# the text tower at 3072 from position 1024), against its plain run at
# phase 16 (c)'s bf16 rule; its vision prefill, 64 text tokens replayed
# and 16 greedy; its split training cut to 4 layers (1 vision + 1 text
# tower, 3 server layers: 3.09 B params, f32) at 4 x 1280 (256 text
# tokens), 3 steps, merged by the sequence concatenation (no kernel)
WH_ARCH, VL_ARCH = "whisper-tiny", "internvl2-26b"
WH_BATCH, WH_TEXT, WH_GEN, WH_TRAIN_STEPS = 8, 448, 32, 5
WHISPER_TRAIN_SHAPE = (2, 8 * 1500, 384)
WHISPER_TRAIN_TIME_SHAPES = [("avg", WHISPER_TRAIN_SHAPE)]
DECODE_EQUIV_TOL = 2e-3
VL_TEXT, VL_REPLAY, VL_GEN = 3072, 64, 16
VL_TRAIN_LAYERS, VL_TRAIN_STEPS = 4, 3
VL_TRAIN_BATCH, VL_TRAIN_SEQ = 4, 1280
# phase 18's flash shapes: internvl2-26b's server at 4096 and its text
# tower at 3072, bf16 (a group of 6, no path ran before)
FLASH_VLM_BF16 = [(1, 48, 8, 4096, 128), (1, 48, 8, 3072, 128)]
# phase 19, training past 2048 tokens: the flash backward at every
# instantiation (head dim x dtype) at 2304 tokens, groups of 3 (6 q / 2 kv
# heads), against the plain backward, each gradient within these shares
# of its largest plain entry (f32: the kernels' 3xTF32 products, ~22
# bits, against cuBLAS's f32 products, summed in other orders; bf16: one
# bf16 rounding of each output, 2^-8 of its size, beside it)
FLASH_BWD_S = 2304
FLASH_BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the forward's logsumexp against the plain one (absolute: the scores'
# 3xTF32 products and ex2.approx leave ~1e-6 of a logsumexp of ~10)
FLASH_LSE_TOL = 1e-4
# (B, H, Hkv, S, D) on the path: smollm-360m at 2 x 4096, server and towers
FLASH_TRAIN_SHAPES = [(2, 15, 5, 4096, 64), (2, 3, 1, 4096, 64)]
# (b) smollm-360m cut to 4 layers (2 tower + 2 server) at 1 x 4096, the
# kernel step's gradients within this share of each leaf's largest plain
# entry; (c) full width, train_split K = 4 avg over threads at 2 x 4096;
# (d) the launcher at 2 x 4096 over threads
LT_LAYERS, LT_MONO_BATCH, LT_SEQ = 4, 1, 4096
LT_GRAD_REL = 1e-3
LT_BATCH, LT_STEPS, LT_CLI_STEPS = 2, 3, 2
# figures of earlier phases that phases 14 and 15 print their own beside
MEASURED: dict = {}


def log(*parts) -> None:
    print(*parts, flush=True)


def reset_launches() -> None:
    mp.reset_launches()
    fa.reset_launches()
    ssd.reset_launches()


def read_launches() -> dict:
    """Every kernel's count (the flash backward's four kernels each
    once per backward call), and the flash kernel's again by head dim
    (both dtypes), as ``flash_attention_kernel[D=d]``, and by bf16
    instantiation, as ``flash_attention_kernel[D=d,bf16]``."""
    by_dim = dict.fromkeys(fa.HEAD_DIMS, 0)
    for (d, _), n in fa.launches_by_instance.items():
        by_dim[d] += n
    return {**mp.launches, **fa.launches,
            **{flash_name(d): n for d, n in by_dim.items()},
            **{flash_name(d, torch.bfloat16): n
               for (d, dtype), n in fa.launches_by_instance.items()
               if dtype == torch.bfloat16},
            **ssd.launches, **fa.bwd_launches}


def flash_name(head_dim: int, dtype=None) -> str:
    """The flash count at ``head_dim``: of both dtypes, or of ``dtype``
    bf16 alone."""
    tag = ",bf16" if dtype == torch.bfloat16 else ""
    return f"flash_attention_kernel[D={head_dim}{tag}]"


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
        [NOWAIT_SHAPE, SSM_TRAIN_SHAPE, TREE_SHAPE, HYBRID_TRAIN_SHAPE,
         WHISPER_TRAIN_SHAPE]
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
        MLP_SHAPES + [NOWAIT_SHAPE, SSM_TRAIN_SHAPE, TREE_SHAPE,
                      HYBRID_TRAIN_SHAPE, WHISPER_TRAIN_SHAPE]
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
            NOWAIT_TIME_SHAPES + SSM_TRAIN_TIME_SHAPES + TREE_TIME_SHAPES + \
            HYBRID_TRAIN_TIME_SHAPES + WHISPER_TRAIN_TIME_SHAPES:
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
        NOWAIT_TIME_SHAPES + SSM_TRAIN_TIME_SHAPES + TREE_TIME_SHAPES \
        + HYBRID_TRAIN_TIME_SHAPES + WHISPER_TRAIN_TIME_SHAPES
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
    server = split_program.get_program(cfg).server_params(params)
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

def train(cfg, steps: int, device: str, params=None, *, batch=TRAIN_BATCH,
          seq=TRAIN_SEQ, **kw):
    """One ``train_split`` run of ``batch`` x ``seq``; returns (out,
    metrics, seconds, launches during the run, peak device memory)."""
    loader = LMBatchLoader(cfg, batch, seq, seed=SEED)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    kw.setdefault("print_fn", log)
    out, metrics, _ = train_split(
        cfg, loader, steps=steps, batch=batch, seq=seq,
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
    Returns the largest f32 |error| per head dim, and the largest bf16
    one keyed ``(D, "bfloat16")``."""
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
    worst = {**dict.fromkeys(fa.HEAD_DIMS, 0.0),
             **{(d, "bfloat16"): 0.0 for d in fa.HEAD_DIMS}}
    n = 0
    model_layout = FLASH_PATH_SHAPES + FLASH_WIDE_SHAPES + \
        FLASH_QWEN_SHAPES + FLASH_MOE_F32 + FLASH_MOE_BF16 + FLASH_VLM_BF16
    for shape in FLASH_SMALL_SHAPES + model_layout:
        for causal in (True, False) if shape[3] <= 8192 else (True,):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = _flash_inputs(shape, dtype, gen,
                                        shape in model_layout)
                got = fa.flash_attention(q, k, v, causal=causal)
                want = ref.flash_attention(q.float(), k.float(), v.float(),
                                           causal=causal)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != dtype:
                    raise AssertionError(f"flash {shape}: {tuple(got.shape)} "
                                         f"{got.dtype}")
                if not torch.isfinite(got).all():
                    raise AssertionError(f"flash {shape}: non-finite output")
                rtol, atol = FLASH_TOL[dtype]
                torch.testing.assert_close(got.float(), want, rtol=rtol,
                                           atol=atol)
                key = shape[4] if dtype == torch.float32 else (
                    shape[4], "bfloat16")
                worst[key] = max(worst[key], float(
                    (got.float() - want.float()).abs().max()))
                n += 1
                del q, k, v, got, want
    torch.cuda.empty_cache()
    log(f"flash kernel: {n} cases match the plain version (f32: rtol and "
        f"atol 5e-4; bf16: against the plain f32 output from the same "
        f"inputs, rtol 2^-7, atol 1e-4; (B, H, Hkv, S, D) in "
        f"{FLASH_SMALL_SHAPES}, "
        f"{FLASH_PATH_SHAPES}, {FLASH_WIDE_SHAPES}, {FLASH_QWEN_SHAPES}, "
        f"{FLASH_MOE_F32}, {FLASH_MOE_BF16} and {FLASH_VLM_BF16}, "
        f"causal and full up "
        f"to 8192 tokens); worst f32 |err| by head dim "
        + ", ".join(f"D {d}: {worst[d]:.3e}" for d in fa.HEAD_DIMS)
        + "; bf16 " + ", ".join(f"D {d}: {worst[(d, 'bfloat16')]:.3e}"
                                for d in fa.HEAD_DIMS))
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


def flash_bound(B, H, Hkv, S, D, dtype=torch.float32, causal=True) -> tuple:
    """Least time on an H100 SXM for the kernel's work: two D-deep
    products per attended (q, kv) pair, in f32 each as three TF32 products
    (3xTF32) at the tensor cores' dense TF32 rate, in bf16 once at their
    dense bf16 rate; vs q, k, v read once and o written once.  Also
    returns the f32-FMA figure (the same products at the f32 rate outside
    the tensor cores) and the flops."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * D * B * H * pairs
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * itemsize
    t_ops = (3 * flops / H100_TF32_FLOPS if dtype == torch.float32
             else flops / H100_BF16_FLOPS)
    t_bytes = nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            max(flops / H100_F32_FLOPS, t_bytes) * 1e3, flops)


def time_flash(card: str) -> dict:
    """Every shape of FLASH_TIME_SHAPES and FLASH_MOE_F32, causal f32, and
    of FLASH_QWEN_SHAPES and FLASH_MOE_BF16, causal bf16, in the model's
    layout: the kernel, the
    plain version, one library call and the bound, by shape (the bf16 rows
    keyed ``(shape, torch.bfloat16)``).  The library call is
    scaled_dot_product_attention's memory-efficient backend (in bf16 its
    flash backend) on kv heads repeated before the call: this PyTorch's
    fused f32 backends refuse enable_gqa=True, and its math backend would
    hold the 64 GB score matrix at 32768.  At the 8192-token smollm-360m
    shape the enable_gqa=True call (the math backend) is timed too, for
    the record."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention

    rows = {}
    for shape, dtype in [(s, torch.float32) for s in FLASH_TIME_SHAPES
                         + FLASH_MOE_F32] + \
            [(s, torch.bfloat16) for s in FLASH_QWEN_SHAPES
             + FLASH_MOE_BF16 + FLASH_VLM_BF16]:
        B, H, Hkv, S, D = shape
        gen = torch.Generator(device="cuda").manual_seed(S + D)
        q, k, v = _flash_inputs(shape, dtype, gen, True)
        kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
        backends = [SDPBackend.EFFICIENT_ATTENTION] if \
            dtype == torch.float32 else [SDPBackend.FLASH_ATTENTION]

        def library():
            with sdpa_kernel(backends):
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
            flash_bound(*shape, dtype=dtype)
        got, want = fns[""](), fns["library_"]()
        torch.cuda.synchronize()
        row["library_max_abs_diff"] = float((got.float() - want.float()
                                             ).abs().max())
        f32 = dtype == torch.float32
        rows[shape if f32 else (shape, dtype)] = row
        name = str(dtype).removeprefix("torch.")
        log(f"time flash causal {name} ({B}, {H}/{Hkv}, {S}, {D}): per call "
            f"(device): kernel {row['ms']:.6f} ({row['device_ms']:.6f}) ms = "
            f"{flops / row['device_ms'] / 1e9:.2f} TFLOP/s "
            f"({100 * row['bound_ms'] / row['device_ms']:.1f}% of the "
            f"{'3xTF32' if f32 else 'bf16'} tensor-core bound, "
            f"{100 * row['fma_bound_ms'] / row['device_ms']:.1f}% of the "
            f"f32-FMA bound), plain "
            f"{row['plain_ms']:.6f} ({row['plain_device_ms']:.6f}) ms, "
            f"library {row['library_ms']:.6f} ({row['library_device_ms']:.6f})"
            f" ms (max |kernel - library| {row['library_max_abs_diff']:.3e}),"
            + (f" library enable_gqa=True {row['library_gqa_ms']:.6f} "
               f"({row['library_gqa_device_ms']:.6f}) ms,"
               if "library_gqa_ms" in row else "")
            + f" bound {row['bound_ms']:.6f} ms ({row['bound_by']}, "
            f"{'3xTF32 at 495' if f32 else 'bf16 at 989'} TFLOP/s), "
            f"fma_bound {row['fma_bound_ms']:.6f} ms (f32 at 67 TFLOP/s) | "
            f"{card}")
        del q, k, v, kr, vr, got, want
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 6: long-prompt split serving
# ---------------------------------------------------------------------------

def serve_recording(cfg, params, prompts, new_tokens, *, use_kernel=True,
                    sampled: dict | None = None, **kw):
    """``serve`` that also keeps each request's prefill logits (requests
    are admitted in submission order) and the server's wire report; with
    ``sampled``, the f32 logits each token was drawn from, by request
    id."""
    srv = make_server(cfg, params, "cuda", use_kernel=use_kernel, **kw)
    logits = []
    prefill = srv._fns.prefill

    def recording_prefill(*args):
        out, cache = prefill(*args)
        logits.append(out[0].detach().clone())
        return out, cache

    srv._fns.prefill = recording_prefill
    if sampled is not None:
        sample = srv._sample

        def recording_sample(rid, pos, row):
            sampled.setdefault(rid, []).append(row.detach().float().clone())
            return sample(rid, pos, row)

        srv._sample = recording_sample
    for p, n in zip(prompts, new_tokens):
        srv.submit(p, max_new_tokens=n)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        results = srv.run()
    finally:
        # the recorder refers to the server: without this cycle broken,
        # the server's tree and caches would outlive the call
        srv.__dict__.pop("_sample", None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if [len(r.tokens) for r in results] != list(new_tokens):
        raise AssertionError("long serving: a request did not complete")
    return ([r.tokens for r in results], dict(srv.stats), seconds, launches,
            logits, srv.wire_report(), dict(srv.cut_cache.stats))


def serve_long(card: str) -> int:
    cfg = dataclasses.replace(get_arch("smollm-360m"), num_layers=LONG_LAYERS)
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
    log(f"long serving: {cfg.name} full width at {cfg.num_layers} layers, "
        f"K={K}, prompts {LONG_PROMPTS}, "
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
        f"run's | {card}")
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
    """The backward kernel at SSD_BWD_TIME_SHAPES (phase 12's server and
    tower shapes, zamba2-7b's): per call and on the device, the plain
    backward likewise, and the bound (3xTF32 vs bytes, with the f32-FMA
    figure beside it).  No single PyTorch call computes this gradient
    (autograd of the plain forward is a dozen calls), so there is no
    library time."""
    rows = {}
    for shape in SSD_BWD_TIME_SHAPES:
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
        B, S, H, P, N, Q = shape
        plan = ssd.bwd_plan(*shape, torch.device("cuda", 0))
        log(f"time ssd bwd f32 ({B}, {S}, {H} heads, P {P}, N {N}, Q {Q}; HG "
            f"{plan['heads']}, {plan['groups']} groups, {plan['blocks']} "
            f"blocks): "
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
        B, S, H, P, N, Q = shape
        gen = torch.Generator(device="cuda").manual_seed(S + 1)
        x, dt, A, Bm, Cm = _ssd_inputs(shape, gen)
        a, xdt = dt * A, x * dt[..., None]
        b, c = Bm[:, :, 0], Cm[:, :, 0]
        big = S > 8192
        fns = {"": lambda: ssd.ssd_chunk(xdt, a, b, c, Q),
               "plain_": lambda: ref.ssd_chunks(xdt, a, b, c, Q)}
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
        log(f"time ssd f32 ({B}, {S}, {H} heads, P {P}, N {N}, Q {Q}; HG "
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
              masks=None, steps: int = MLP_STEPS) -> tuple:
    """The paper tables' loop (``paper_tables.train_split`` /
    ``train_centralized``): AdamW(3e-3), batch 256, MLP_STEPS (or the first
    ``steps``) over ``minibatches(seed=0)`` of a device-resident split, on
    the params' device.  Drops draw their masks from ``gen``, or take
    ``masks[i]``.  Returns (params, losses, seconds)."""
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
        if i >= steps:
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
    """One run on the card and its first MLP_CHECK_STEPS steps on the
    card's CPU from the same weights: their losses must agree within 1e-5
    (the CPU twin stops there: its whole run took most of the phase's
    time on the host).  Prints the card's test accuracy, F1 and samples/s.
    The card's run draws its drop masks from ``gen``; the CPU's takes
    ``cpu_masks``, the same masks.  Returns the card's params."""
    out = {
        "card": mlp_train(cfg, dsets["card"], _to(init, "cuda"),
                          centralized=centralized, num_drop=num_drop,
                          gen=gen),
        "cpu": mlp_train(cfg, dsets["cpu"], init, centralized=centralized,
                         num_drop=num_drop, masks=cpu_masks,
                         steps=MLP_CHECK_STEPS)}
    diff = max(abs(a - b) for a, b in zip(out["card"][1][:MLP_CHECK_STEPS],
                                          out["cpu"][1][:MLP_CHECK_STEPS]))
    if diff > 1e-5:
        raise AssertionError(f"{label}: the first {MLP_CHECK_STEPS} losses "
                             f"on the card {out['card'][1][:5]} and the CPU "
                             f"{out['cpu'][1][:5]} differ by {diff:.3e}")
    acc, f1 = mlp_eval(cfg, dsets["card"], out["card"][0], centralized)
    seconds = out["card"][2]
    log(f"mlp {label}: {MLP_STEPS} steps, {MLP_STEPS * MLP_BATCH / seconds:.1f}"
        f" train samples/s on the card ({seconds:.4f} s), loss "
        f"{out['card'][1][0]:.6f} -> {out['card'][1][-1]:.6f}, first "
        f"{MLP_CHECK_STEPS} losses within {diff:.3e} of the CPU's; test acc "
        f"/ F1 {acc:.4f} / {f1:.4f} | {card}")
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

    # (c) a ring of MONO_RING slots against a linear cache under the same
    # window
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
    server = split_program.get_program(cfg).server_params(
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
               verified: str = "step-0 verification vs protocol_step", *,
               transport: str = "multiproc", steps: int = LAUNCH_STEPS,
               batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> dict:
    """(e) ``python -m repro_torch.launch.train --transport multiproc`` as
    a user runs it (full-width smollm-360m, the card by default), with
    ``extra`` flags: exit 0, the ``verified`` step-0 line and the
    summary's keys.  Phase 19 (d) runs it over ``inproc`` at 2 x 4096."""
    out_json = LAUNCH_DIR / "launch.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--transport",
           transport, "--steps", str(steps), "--batch", str(batch),
           "--seq", str(seq), *extra, "--json", str(out_json)]
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
    if set(summary) != keys or summary["transport"] != transport or \
            len(run["losses"]) != steps:
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


# ---------------------------------------------------------------------------
# phase 16: the other dense configs and the hybrid family — stablelm-3b
# and qwen3-32b (qk-norm) long-prompt split serving, zamba2-7b forward,
# generate and split training
# ---------------------------------------------------------------------------

def hybrid_cfg(every: int, num_layers: int, base=None):
    """``base`` (reduced zamba2-7b by default) at ``num_layers`` layers and
    one shared attention block after every ``every`` Mamba2 layers."""
    cfg = base or get_arch(HY_ARCH).reduced()
    return dataclasses.replace(
        cfg, num_layers=num_layers,
        hybrid=dataclasses.replace(cfg.hybrid, shared_attn_every=every))


def hybrid_counts(cfg) -> dict:
    """Per forward of the hybrid: every Mamba2 layer of the server and the
    towers runs the SSD kernel once, every super-block's shared
    attention once (the flash kernel past 2048 tokens)."""
    v = cfg.vertical
    n_server = cfg.num_layers - v.tower_layers
    n_super, _ = tfm.hybrid_layout(n_server, cfg.hybrid.shared_attn_every)
    return {"ssd": n_server + v.num_clients * v.tower_layers,
            "super": n_super}


def other_small_against_cpu() -> None:
    """(a) Reduced stablelm-3b, qwen3-32b (qk-norm) and zamba2-7b at
    ``every`` 2 over 6 layers (2 super-blocks and a tail), same weights,
    the card against the CPU: ``forward`` logits within 1e-4 and greedy
    ``generate`` tokens identical (the zamba2 forward over 2304 tokens, so
    that its shared attention runs the flash kernel at its head dim 112);
    then stablelm at head dim 80 and qwen3 at 128 served split on a
    2304-token prompt, as phase 6 serves smollm."""
    rng = np.random.default_rng(SEED)
    cases = [(SL_ARCH, get_arch(SL_ARCH).reduced(), 64),
             (QW_ARCH, get_arch(QW_ARCH).reduced(), 64),
             (HY_ARCH, dataclasses.replace(hybrid_cfg(2, 6), head_dim=112),
              2304)]
    for name, cfg, S in cases:
        gen = torch.Generator(device="cpu").manual_seed(SEED)
        cpu_params = backbone.init_params(cfg, gen, device="cpu")
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, S)))
        out = {}
        for device, params in (("cpu", cpu_params),
                               ("cuda", _to(cpu_params, "cuda"))):
            reset_launches()
            logits, _ = backbone.forward(params,
                                         {"tokens": tokens.to(device)}, cfg)
            launches = read_launches()
            toks = generate(params, cfg, tokens[:, :16].to(device),
                            max_new_tokens=8)
            out[device] = (logits.cpu(), toks.cpu(), launches)
        want = {}
        if cfg.family == "hybrid":
            n = hybrid_counts(cfg)
            want = {"ssd_chunk_kernel": n["ssd"],
                    "flash_attention_kernel": n["super"],
                    flash_name(cfg.resolved_head_dim()): n["super"]}
        expect_launches(out["cuda"][2], want)
        if any(out["cpu"][2].values()):
            raise AssertionError(f"{name} on the CPU launched kernels: "
                                 f"{out['cpu'][2]}")
        diff = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        if not torch.isfinite(out["cuda"][0]).all() or diff > 1e-4:
            raise AssertionError(f"reduced {name}: card logits differ from "
                                 f"the CPU's by {diff:.3e} > 1e-4")
        if not torch.equal(out["cuda"][1], out["cpu"][1]):
            raise AssertionError(f"reduced {name}: card tokens differ from "
                                 f"the CPU's")
        log(f"small {name}: reduced ({cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, head dim {cfg.resolved_head_dim()}"
            + (f", qk-norm" if cfg.qk_norm else "")
            + (f", every {cfg.hybrid.shared_attn_every}"
               if cfg.hybrid else "")
            + f") on the card matches the CPU path: forward over 2 x {S} "
            f"tokens, logits max |diff| {diff:.3e} <= 1e-4, launches "
            f"{ {k: v for k, v in out['cuda'][2].items() if v} }; greedy "
            f"generate of 2 x 8 tokens identical")
    check_small_long_against_cpu(SL_ARCH, head_dim=80)
    check_small_long_against_cpu(QW_ARCH, head_dim=128)


def plain_bf16(arch: str, sampled: dict, psampled: dict, tokens: list,
               ptokens: list) -> str:
    """The bf16 kernel run against the plain one, request by request (in
    submission order) and step by step while their tokens agree (the
    first step's logits are the prefill's): the logits each token was
    drawn from within ``PLAIN_BF16_TOL`` of the plain run's largest at that
    step.  A token may differ only where the plain run's top-2 gap is no
    more than twice that step's largest difference; the request is then
    held no further.  Returns the summary."""
    held, parted, worst = 0, 0, []
    for i, rid in enumerate(sorted(psampled)):
        worst.append(0.0)
        for t, (got, want) in enumerate(zip(sampled[rid], psampled[rid])):
            scale = float(want.abs().max())
            diff = float((got - want).abs().max())
            worst[i] = max(worst[i], diff / scale)
            if diff > PLAIN_BF16_TOL * scale:
                raise AssertionError(
                    f"{arch} request {i} step {t}: kernel vs plain logits "
                    f"max |diff| {diff:.4e} > {PLAIN_BF16_TOL} x {scale:.4e}")
            held += 1
            if tokens[i][t] != ptokens[i][t]:
                top = torch.topk(want, 2).values
                gap = float(top[0] - top[1])
                if gap > 2 * diff:
                    raise AssertionError(
                        f"{arch} request {i} step {t}: kernel token "
                        f"{tokens[i][t]} != plain {ptokens[i][t]} at top-2 "
                        f"gap {gap:.4e} > 2 x max |diff| {diff:.4e}")
                parted += 1
                break
    return (f"gives {'identical' if tokens == ptokens else 'other'} tokens "
            f"({parted} of {len(tokens)} requests part at a near-tie); over "
            f"the {held} steps whose contexts agree, the logits each token "
            f"was drawn from (the first, the prefill's) are within "
            f"{', '.join(f'{w:.3e}' for w in worst)} of the step's largest, "
            f"request by request (tol {PLAIN_BF16_TOL})")


def serve_other(card: str, arch: str, prompts_len: list, new: list, *,
                dtype=torch.float32) -> dict:
    """Full-width ``arch`` (random weights from a seed, in ``dtype``),
    K = 4, two slots, greedy: each long prompt's prefill timed alone, then
    the whole traffic with the counters reset just before the run and read
    just after — per prompt past 2048 tokens one flash launch per server
    and tower layer, all at the config's head dim and in ``dtype``, one
    merge launch per merge, the ledger equal to the cost model; then a
    run with the plain merge and attention: in f32 identical tokens and
    prefill logits within 1e-3, in bf16 ``plain_bf16``'s gates.  Returns
    the launches."""
    cfg = get_arch(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = backbone.init_params(cfg, gen, device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in _leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    if n_params != backbone.param_count(cfg):
        raise AssertionError(f"{arch} has {n_params} params, expected "
                             f"{backbone.param_count(cfg)}")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, s) for s in prompts_len]
    K = cfg.vertical.num_clients
    per_prompt = (cfg.num_layers - cfg.vertical.tower_layers
                  + K * cfg.vertical.tower_layers)
    long = [s for s in prompts_len if s * s > attn_lib.FLASH_THRESHOLD ** 2]
    head_dim = cfg.resolved_head_dim()
    kw = dict(cache_len=max(s + n for s, n in zip(prompts_len, new)),
              max_batch=2, cut_cache_bytes=2 * max(prompts_len) * cfg.d_model
              * 4)
    log(f"{arch}: full width, {n_params} params ({param_bytes} bytes "
        f"{str(dtype).removeprefix('torch.')}; init {t_init:.2f} s, "
        f"max_memory_allocated during init {init_peak} bytes), K={K}, head "
        f"dim {head_dim} (server {cfg.num_heads}/{cfg.num_kv_heads} heads, "
        f"towers {cfg.num_heads // K}/{max(1, cfg.num_kv_heads // K)}), "
        f"qk-norm {cfg.qk_norm}, prompts {prompts_len}, new tokens {new}, 2 "
        f"slots, cache_len {kw['cache_len']}")
    serve(cfg, params, [prompts[0][:64]], [2], **kw)  # warm-up

    srv = make_server(cfg, params, "cuda", **kw)
    prefill_s = []
    for p in (p for p in prompts if len(p) in long):
        srv.submit(p, max_new_tokens=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.run()
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    del srv
    log(f"{arch} prefill (max_new_tokens=1, one request at a time): "
        + ", ".join(f"{s} tokens {s / t:.1f} tok/s ({t:.4f} s)"
                    for s, t in zip(long, prefill_s)) + f" | {card}")

    torch.cuda.reset_peak_memory_stats()
    sampled = {}
    tokens, stats, t_main, launches, logits, wire, _ = serve_recording(
        cfg, params, prompts, new, sampled=sampled, **kw)
    peak = torch.cuda.max_memory_allocated()
    if stats["reprefills"]:
        raise AssertionError(f"{arch} serving re-prefilled: {stats}")
    merges = stats["prefills"] + sum(n - 1 for n in new)
    flash = per_prompt * len(long)
    expect_launches(launches, {"flash_attention_kernel": flash,
                               flash_name(head_dim): flash,
                               flash_name(head_dim, torch.bfloat16):
                               flash if dtype == torch.bfloat16 else 0,
                               "merge_reduce_kernel": merges})
    size = torch.finfo(dtype).bits // 8  # the towers' cuts are in dtype
    pf = [costs.serve_prefill_bytes(s, cfg.d_model, K, itemsize=size)["total"]
          for s in prompts_len]
    dc = costs.serve_decode_bytes(cfg.d_model, K, rounds=sum(new) - len(new),
                                  itemsize=size)["total"]
    if wire["total"] != sum(pf) + dc:
        raise AssertionError(f"{arch}: ledger {wire['total']} bytes != cost "
                             f"model {sum(pf) + dc}")
    if len(logits) != len(prompts) or not all(
            torch.isfinite(x).all() for x in logits):
        raise AssertionError(f"{arch}: missing or non-finite prefill logits")
    line = (f"{arch} serving continuous: {len(prompts)} requests, "
            f"{stats['tokens']} tokens, {stats['decode_rounds']} decode "
            f"rounds, {launches['flash_attention_kernel']} "
            f"flash_attention_kernel launches, all at D = {head_dim} in "
            f"{str(dtype).removeprefix('torch.')} ({per_prompt} per prompt "
            f"past 2048 tokens x {len(long)}), "
            f"{launches['merge_reduce_kernel']} merge_reduce_kernel launches "
            f"({merges} merges); ledger {wire['total']} bytes = cost model; "
            f"wall {t_main:.4f} s; max_memory_allocated {peak} bytes")
    psampled = {}
    ptokens, _, t_plain, plaunch, plogits, _, _ = serve_recording(
        cfg, params, prompts, new, use_kernel=False, sampled=psampled, **kw)
    if any(plaunch.values()):
        raise AssertionError(f"the plain run launched kernels: {plaunch}")
    line += (f"; the plain run (merge and attention; {t_plain:.4f} s, no "
             f"launch) ")
    if dtype == torch.bfloat16:
        line += plain_bf16(arch, sampled, psampled, tokens, ptokens)
    else:
        diffs = [float((a - b).abs().max()) for a, b in zip(logits, plogits)]
        if max(diffs) > 1e-3 or ptokens != tokens:
            raise AssertionError(f"{arch}: kernel vs plain prefill logits "
                                 f"{diffs}, tokens equal {ptokens == tokens}")
        line += (f"gives identical tokens, prefill logits max |diff| "
                 f"{max(diffs):.3e} (tol 1e-3)")
    log(line + f" | {card}")
    del params
    torch.cuda.empty_cache()
    return launches


def hybrid_forward(card: str) -> dict:
    """(d) Full-width zamba2-7b (f32, random weights from a seed; 13
    super-blocks of 6 Mamba2 layers and a tail of 1 on the server, K = 4
    Mamba2 towers of 2 layers at width 896): ``make_prefill`` over one
    request of each HY_FORWARDS length, with the counters reset just
    before each run and read just after (87 SSD launches: 79 server + 4 x
    2 tower layers; 13 flash launches at D = 112, one per super-block);
    at 8192 the plain forward (``use_kernel=False``) launches nothing and
    its logits agree within 1e-3.  Then greedy ``generate`` of HY_GEN: the
    prompt replayed through ``decode_step`` (no launch), its first tokens
    the forward's argmax.  Returns the launches."""
    cfg = get_arch(HY_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = backbone.init_params(cfg, gen, device="cuda")
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in _leaves(params))
    if n_params != backbone.param_count(cfg):
        raise AssertionError(f"{HY_ARCH} has {n_params} params, expected "
                             f"{backbone.param_count(cfg)}")
    n = hybrid_counts(cfg)
    d = cfg.resolved_head_dim()
    want = {"ssd_chunk_kernel": n["ssd"], "flash_attention_kernel": n["super"],
            flash_name(d): n["super"]}
    log(f"hybrid model: {HY_ARCH} full width ({cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, d_state {cfg.ssm.d_state}, "
        f"{cfg.ssm.n_heads(cfg.d_model)} SSD heads of {cfg.ssm.head_dim}, "
        f"shared attention every {cfg.hybrid.shared_attn_every}: "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {d}, d_ff {cfg.d_ff}), "
        f"{n_params} params f32 (max_memory_allocated during init "
        f"{init_peak} bytes), K={cfg.vertical.num_clients} towers of "
        f"{cfg.vertical.tower_layers} Mamba2 layers (width "
        f"{cfg.d_model // cfg.vertical.num_clients}, "
        f"{cfg.ssm.n_heads(cfg.d_model // cfg.vertical.num_clients)} SSD "
        f"heads); per forward {n['ssd']} SSD and {n['super']} flash launches")
    prefill = {True: backbone.make_prefill(cfg),
               False: backbone.make_prefill(cfg, use_kernel=False)}
    rng = np.random.default_rng(SEED)

    def run(tokens, use_kernel: bool):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = prefill[use_kernel](params, {"tokens": tokens})
        torch.cuda.synchronize()
        return (logits, time.perf_counter() - t0, read_launches(),
                torch.cuda.max_memory_allocated())

    warm = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 256)),
                           device="cuda")
    for use_kernel in (True, False):
        run(warm, use_kernel)
    total = dict.fromkeys(want, 0)
    for B, S in HY_FORWARDS:
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                 device="cuda")
        logits, t_kernel, launches, peak = run(tokens, True)
        expect_launches(launches, want)
        for k in total:
            total[k] += launches[k]
        kept = logits[:, -SSM_TAIL:].clone()
        del logits
        if not torch.isfinite(kept).all():
            raise AssertionError(f"hybrid forward ({B}, {S}): non-finite "
                                 "logits")
        line = (f"hybrid forward ({B}, {S}): kernel {B * S / t_kernel:.1f} "
                f"tok/s ({t_kernel:.4f} s, launches "
                f"{ {k: v for k, v in launches.items() if v} }, "
                f"max_memory_allocated {peak} bytes)")
        if S <= 8192:
            plain, t_plain, plaunch, ppeak = run(tokens, False)
            if any(plaunch.values()):
                raise AssertionError(f"the plain forward launched kernels: "
                                     f"{plaunch}")
            pkept = plain[:, -SSM_TAIL:]
            diff = float((kept - pkept).abs().max())
            top = torch.topk(pkept[:, -1], 2, dim=-1).values
            held = (top[:, 0] - top[:, 1]) > 2 * SSM_LOGIT_TOL
            same = torch.equal(kept[:, -1].argmax(-1)[held],
                               pkept[:, -1].argmax(-1)[held])
            line += (f"; plain {B * S / t_plain:.1f} tok/s ({t_plain:.4f} s, "
                     f"0 launches, max_memory_allocated {ppeak} bytes); "
                     f"logits max |kernel - plain| over the last {SSM_TAIL} "
                     f"positions {diff:.3e} (tol 1e-3), last-position argmax "
                     f"identical {same} (held where the plain top-2 gap "
                     f"exceeds 2e-3: {held.tolist()})")
            if diff > SSM_LOGIT_TOL or not same:
                raise AssertionError(f"hybrid forward ({B}, {S}): kernel vs "
                                     f"plain logits {diff:.3e}, argmax same "
                                     f"{same}")
            del plain, pkept
        log(line + f" | {card}")
        del kept
        torch.cuda.empty_cache()

    (B, S), new = HY_GEN
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                              device="cuda")
    first_logits, _, _, _ = run(prompts, True)
    first = first_logits[:, -1].argmax(-1)
    generate(params, cfg, prompts[:, :4], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    glaunch = read_launches()
    if any(glaunch.values()):
        raise AssertionError(f"hybrid generate launched kernels: {glaunch}")
    if out.shape != (B, new) or not torch.equal(out[:, 0], first):
        raise AssertionError(f"hybrid generate: first tokens "
                             f"{out[:, 0].tolist()} != the forward's argmax "
                             f"{first.tolist()}")
    log(f"hybrid generate: {B} prompts of {S} tokens, {new} new tokens each, "
        f"greedy, the prompt replayed through decode_step, no launch, wall "
        f"{t_gen:.4f} s ({B * (S + new) / t_gen:.1f} replayed and generated "
        f"tokens/s); first tokens {first.tolist()} = the kernel forward's "
        f"argmax (top-2 gap {top2_gap(first_logits[:, -1]):.4f}) | {card}")
    del params, first_logits
    torch.cuda.empty_cache()
    return total


def hybrid_train(card: str) -> dict:
    """(e) zamba2-7b at full width cut to HY_TRAIN_LAYERS layers (2
    super-blocks and a tail of 1 on the server; AdamW over the full 81
    layers' 6.65 B f32 params would need 106 GB), K = 4, avg,
    ``train_split`` over inproc, serial, 8 x 256 tokens, HY_TRAIN_STEPS
    steps, step 0 verified against ``protocol_step`` at 1e-5.  Counters
    reset just before the run and read just after: per step each server
    Mamba2 layer runs ``ssd_chunk_kernel`` once and each tower layer twice
    (the worker re-runs its forward for the vjp), every Mamba2 layer
    ``ssd_chunk_bwd_kernel`` once, one avg merge each way at (4, 2048,
    3584); step 0's verification once more of each SSD count.  Every
    step's ledger equals the byte models.  Returns the launches."""
    cfg = dataclasses.replace(get_arch(HY_ARCH), num_layers=HY_TRAIN_LAYERS)
    v = cfg.vertical
    torch.cuda.empty_cache()
    with merge_calls() as merges:
        _, metrics, seconds, launches, peak = train(cfg, HY_TRAIN_STEPS,
                                                    "cuda")
    expect_launches(launches, ssm_train_launches(cfg, HY_TRAIN_STEPS, True))
    if merges != [("avg", HYBRID_TRAIN_SHAPE)] * HY_TRAIN_STEPS:
        raise AssertionError(f"hybrid train: role 0 merged {merges}")
    if metrics.step0_max_dgrad is None or metrics.step0_max_dgrad > 1e-5:
        raise AssertionError(f"hybrid train: step 0 not verified "
                             f"({metrics.step0_max_dgrad})")
    rows = TRAIN_BATCH * TRAIN_SEQ
    cut = costs.cut_bytes(rows, cfg.d_model)
    head = costs.head_exchange_bytes(rows, cfg.vocab_size)
    want = 2 * v.num_clients * cut + 2 * head
    if [ledger.total() for ledger in metrics.ledgers] != \
            [want] * HY_TRAIN_STEPS:
        raise AssertionError(f"hybrid train: ledgers "
                             f"{[ledger.total() for ledger in metrics.ledgers]}"
                             f" != costs {want}")
    steady = metrics.step_times[1:]
    n_super, n_tail = tfm.hybrid_layout(cfg.num_layers - v.tower_layers,
                                        cfg.hybrid.shared_attn_every)
    log(f"hybrid train: {HY_ARCH} full width at {cfg.num_layers} layers "
        f"({n_super} super-blocks of {cfg.hybrid.shared_attn_every} Mamba2 "
        f"layers and their shared attention, a tail of {n_tail}; K="
        f"{v.num_clients} towers of {v.tower_layers}, avg), f32, serial, "
        f"{HY_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
        f"losses {metrics.losses}, step-0 max |dgrad| vs protocol_step "
        f"{metrics.step0_max_dgrad:.3e} (<= 1e-5); merges avg "
        f"{HYBRID_TRAIN_SHAPE} one each way a step; ledger {want} bytes a "
        f"step = costs; launches {launches}; "
        f"{len(steady) * rows / sum(steady):.1f} train tokens/s over steps "
        f"1-{HY_TRAIN_STEPS - 1} (step times {metrics.step_times} s; step 0 "
        f"includes the verification), wall {seconds:.4f} s with set-up, "
        f"max_memory_allocated {peak} bytes | {card}")
    return launches


def other_phase(card: str) -> dict:
    """Phase 16; returns the launches by sub-phase: ``"stablelm"``,
    ``"qwen3"``, ``"hybrid_forward"``, ``"hybrid_train"``."""
    t0 = time.perf_counter()
    other_small_against_cpu()
    out = {"stablelm": serve_other(card, SL_ARCH, SL_PROMPTS, SL_NEW),
           "qwen3": serve_other(card, QW_ARCH, QW_PROMPTS, QW_NEW,
                                dtype=torch.bfloat16),
           "hybrid_forward": hybrid_forward(card),
           "hybrid_train": hybrid_train(card)}
    log(f"other: phase 16 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: the moe family — deepseek-moe-16b and arctic-480b forward,
# generate and split training with the router's aux-loss slot, and the
# compact bilinear merge
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def moe_routes(forced: list | None = None):
    """Every ``moe_apply`` call's routing during the block, in call order
    (``models/moe.route`` wrapped for the block): the router probs ``(G,
    Sg, E)`` and the top-k experts ``(G, Sg, K)`` in slot order.  With
    ``forced``, another run's record over the same tokens, each call takes
    that run's experts (their gates from its own probs, renormalized as
    ``route`` does), so both runs route and drop alike and every token can
    be held; each call then also records the tokens whose own top-k set
    differs (``flips``: a near-tie that the two runs' roundings tipped)
    and its largest router-prob difference from the other run
    (``dprob``) and that of the probs' means over its tokens (``dmean``:
    an expert's mean prob, which the aux loss weighs)."""
    calls = []
    route = moe_lib.route

    def wrapped(router, xt, cfg):
        probs, top_p, top_idx = route(router, xt, cfg)
        rec = {"probs": probs.detach(), "idx": top_idx.detach()}
        if forced is not None:
            other = forced[len(calls)]
            idx = other["idx"].to(top_idx.device)
            rec["flips"] = int((torch.sort(idx, -1).values != torch.sort(
                top_idx, -1).values).any(-1).sum())
            delta = probs - other["probs"].to(probs.device)
            rec["dprob"] = float(delta.abs().max())
            rec["dmean"] = float(delta.mean((0, 1)).abs().max())
            top_p = torch.gather(probs, -1, idx)
            top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
            rec["idx"] = top_idx = idx
        calls.append(rec)
        return probs, top_p, top_idx

    moe_lib.route = wrapped
    try:
        yield calls
    finally:
        moe_lib.route = route
    if forced is not None and len(calls) != len(forced):
        raise AssertionError(f"{len(calls)} moe calls replayed {len(forced)}")


def replayed(calls: list, cfg, dtype) -> tuple:
    """The routes a replayed run took over from the recorded one: checks
    that its router probs stayed within ``ROUTER_TOL`` of the recorded
    run's; returns (the aux loss's limit, its line).  With the same top-1
    experts the two runs' densities are equal (they sum to 1), so a
    layer's aux moves by at most E * weight * the largest difference of
    an expert's mean prob."""
    flips = sum(c["flips"] for c in calls)
    pairs = sum(c["idx"].shape[0] * c["idx"].shape[1] for c in calls)
    dprob = max(c["dprob"] for c in calls)
    aux_tol = 1e-6 + cfg.moe.num_experts * cfg.moe.router_aux_weight * sum(
        c["dmean"] for c in calls)
    line = (f"routes replayed in {len(calls)} moe calls: {flips} of {pairs} "
            f"(token, layer) pairs would have taken another expert set, "
            f"router probs within {dprob:.3e} (tol {ROUTER_TOL[dtype]:g})")
    if dprob > ROUTER_TOL[dtype]:
        raise AssertionError(f"router probs differ: {line}")
    return aux_tol, line


def moe_small_against_cpu() -> None:
    """(a) Reduced deepseek-moe-16b split and centralized (the centralized
    tree's dense first layer, ``server_dense``) and reduced arctic-480b
    (a dense residual), same weights, the card against the CPU, the CPU
    runs replaying the card runs' routes: the ``forward`` logits within
    1e-4 and the aux loss within 1e-6, and greedy ``generate`` tokens
    identical (the prompt replayed through ``decode_step``)."""
    rng = np.random.default_rng(SEED)
    ds = get_arch(DS_ARCH).reduced()
    cases = [("deepseek-moe-16b", ds),
             ("deepseek-moe-16b centralized", ds.with_vertical(None)),
             ("arctic-480b", get_arch(AR_ARCH).reduced())]
    for name, cfg in cases:
        gen = torch.Generator(device="cpu").manual_seed(SEED)
        cpu_params = backbone.init_params(cfg, gen, device="cpu")
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 64)))
        out, fwd, dec = {}, None, None
        for device, params in (("cuda", _to(cpu_params, "cuda")),
                               ("cpu", cpu_params)):
            reset_launches()
            with moe_routes(fwd) as fwd:
                logits, aux = backbone.forward(
                    params, {"tokens": tokens.to(device)}, cfg)
            launches = read_launches()
            with moe_routes(dec) as dec:
                toks = generate(params, cfg, tokens[:, :16].to(device),
                                max_new_tokens=8)
            out[device] = (logits.cpu(), float(aux), toks.cpu(), launches)
        if any(out["cpu"][3].values()) or any(out["cuda"][3].values()):
            raise AssertionError(f"reduced {name}: the forward at 64 tokens "
                                 f"launched kernels: {out['cuda'][3]}")
        _, line = replayed(fwd, cfg, torch.float32)
        _, dec_line = replayed(dec, cfg, torch.float32)
        diff = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        aux_diff = abs(out["cuda"][1] - out["cpu"][1])
        if not torch.isfinite(out["cuda"][0]).all() or diff > 1e-4 or \
                aux_diff > 1e-6:
            raise AssertionError(f"reduced {name}: card logits differ from "
                                 f"the CPU's by {diff:.3e} (tol 1e-4), aux by "
                                 f"{aux_diff:.3e} (tol 1e-6); {line}")
        if not torch.equal(out["cuda"][2], out["cpu"][2]):
            raise AssertionError(f"reduced {name}: card tokens differ from "
                                 f"the CPU's; {dec_line}")
        log(f"small moe {name}: reduced ({cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.moe.num_experts} experts top-"
            f"{cfg.moe.top_k}, shared {cfg.moe.num_shared_experts}, dense "
            f"residual {cfg.moe.d_ff_dense_residual}, server_dense "
            f"{backbone.params_dense_layers(cfg)}) on the card matches the "
            f"CPU path: forward over 2 x 64 tokens, {line}; logits max "
            f"|diff| {diff:.3e} <= 1e-4, aux {out['cuda'][1]:.8f} vs "
            f"{out['cpu'][1]:.8f} (|diff| {aux_diff:.3e} <= 1e-6); greedy "
            f"generate of 2 x 8 tokens identical, {dec_line}")


def moe_forward_runs(cfg, params, tokens, dtype) -> tuple:
    """``forward`` of ``tokens`` on the kernels, then on the plain path
    replaying the kernel run's routes, the counters reset just before each
    and read just after: returns the kernel run's launches and the line
    that holds the kernel run against the plain one over every token (f32
    logits within 1e-3, phase 13's prefill tolerance; bf16 each position
    within ``PLAIN_BF16_TOL`` of its largest plain logit, phase 16 (c)'s
    rule), the aux within the limit ``replayed`` derives."""
    runs, routes = {}, None
    for use_kernel in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad(), moe_routes(routes) as routes:
            logits, aux = backbone.forward(params, {"tokens": tokens}, cfg,
                                           use_kernel=use_kernel)
        torch.cuda.synchronize()
        runs[use_kernel] = (logits, float(aux), time.perf_counter() - t0,
                            read_launches(), torch.cuda.max_memory_allocated())
        del logits
    if any(runs[False][3].values()):
        raise AssertionError(f"the plain forward launched kernels: "
                             f"{runs[False][3]}")
    (got, aux, t_k, launches, peak), (want, paux, t_p, _, ppeak) = \
        runs[True], runs[False]
    aux_tol, route_line = replayed(routes, cfg, dtype)
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits")
    V = want.shape[-1]
    a, b = got.reshape(-1, V).float(), want.reshape(-1, V).float()
    diff = float((a - b).abs().max())
    if dtype == torch.float32:
        bad = diff > 1e-3
        rule = f"max |diff| {diff:.3e} (tol 1e-3)"
    else:
        rel = float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())
        bad = rel > PLAIN_BF16_TOL
        rule = (f"each within {rel:.3e} of its largest plain logit (tol "
                f"{PLAIN_BF16_TOL}), max |diff| {diff:.3e}")
    bad = bad or abs(aux - paux) > aux_tol
    B, S = tokens.shape
    line = (f"kernel {B * S / t_k:.1f} tok/s ({t_k:.4f} s, launches "
            f"{ {k: v for k, v in launches.items() if v} }, "
            f"max_memory_allocated {peak} bytes); plain {B * S / t_p:.1f} "
            f"tok/s ({t_p:.4f} s, no launch, max_memory_allocated {ppeak} "
            f"bytes); {route_line}; logits over all {B * S} tokens {rule}; "
            f"aux {aux:.8f} vs plain {paux:.8f} (|diff| {abs(aux - paux):.3e},"
            f" tol {aux_tol:.3e})")
    if bad:
        raise AssertionError(f"kernel vs plain forward: {line}")
    del got, want
    return launches, line


def init_on_card(cfg, dtype) -> tuple:
    """The seeded init on the card, timed; returns (params, line).  In a
    dtype other than f32 the init may hold beside the params less than the
    largest f32 tensor it draws whole: one layer's expert stack (moe),
    else a single matrix (one layer's MLP matrix or the embedding
    table), since it draws every stack layer by layer."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = backbone.init_params(cfg, gen, device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in _leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    if n_params != backbone.param_count(cfg):
        raise AssertionError(f"{cfg.name} has {n_params} params, expected "
                             f"{backbone.param_count(cfg)}")
    # no f32 copy of a stack: what the init held beside the params stays
    # below one layer's f32 expert stack (E, d, ff) (moe), else within the
    # largest single f32 matrix (d, ff) or (vocab, d)
    transient = init_peak - base - param_bytes
    d = cfg.d_model
    limit = (cfg.moe.num_experts * d * cfg.d_ff if cfg.moe is not None
             else max(d * cfg.d_ff, cfg.vocab_size * d)) * 4
    if dtype != torch.float32 and transient >= limit:
        raise AssertionError(f"{cfg.name} init held {transient} bytes beside "
                             f"the params (limit {limit})")
    return params, (f"{n_params} params ({param_bytes} bytes "
                    f"{str(dtype).removeprefix('torch.')}; init {t_init:.2f} "
                    f"s, max_memory_allocated during init {init_peak} bytes, "
                    f"{transient} beside the params)")


def moe_flash_counts(cfg) -> int:
    """Flash launches a forward past 2048 tokens: one per attention layer
    of the server and of each tower."""
    v = cfg.vertical
    return cfg.num_layers - v.tower_layers + v.num_clients * v.tower_layers


def deepseek_full(card: str) -> dict:
    """(b) Full-width deepseek-moe-16b (f32, seeded; 26 MoE server layers of
    64 experts top-6 and 2 shared, K = 4 dense towers of 2 layers):
    ``forward`` of one 4096-token prompt on the kernels and on the plain
    path (34 flash launches at D = 128: 26 server at 16 / 16 heads and
    4 x 2 tower at 4 / 4); then greedy ``generate`` of 2 x 32 prompt
    tokens and 8 new at the real capacity (each decode step routes the 2
    streams' tokens as one group: one slot an expert), and at capacity
    factor 100, where nothing is dropped and decode equals the forward:
    those tokens held against the argmax of the plain forward over the
    prompt and the tokens generated (teacher-forced, replaying decode's
    routes), wherever its top-2 gap exceeds 2e-3, at least
    ``MOE_GEN_HELD`` of them.  Returns the forward's launches."""
    cfg = get_arch(DS_ARCH)
    params, init_line = init_on_card(cfg, torch.float32)
    n = moe_flash_counts(cfg)
    K = cfg.vertical.num_clients
    log(f"moe model: {DS_ARCH} full width ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.moe.num_experts} experts of d_ff {cfg.d_ff} "
        f"top-{cfg.moe.top_k}, {cfg.moe.num_shared_experts} shared, capacity "
        f"factor {cfg.moe.capacity_factor}; attention {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim()}, towers "
        f"{cfg.num_heads // K}/{cfg.num_kv_heads // K}), K={K}, f32: "
        f"{init_line}")
    rng = np.random.default_rng(SEED)
    warm = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 256)),
                           device="cuda")
    with torch.no_grad():
        backbone.forward(params, {"tokens": warm}, cfg)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, MOE_PREFILL)), device="cuda")
    launches, line = moe_forward_runs(cfg, params, tokens, torch.float32)
    expect_launches(launches, {"flash_attention_kernel": n,
                               flash_name(128): n})
    log(f"moe forward {DS_ARCH} (1, {MOE_PREFILL}): {line} | {card}")

    (B, S), new = MOE_GEN
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                              device="cuda")
    generate(params, cfg, prompts[:, :4], max_new_tokens=2)  # warm-up
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_NO_DROP))
    out = {}
    for label, c in (("real", cfg), ("no-drop", nodrop)):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with moe_routes() as dec:
            out[label] = generate(params, c, prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        out[label + "_s"] = time.perf_counter() - t0
        if any(read_launches().values()):
            raise AssertionError(f"moe generate launched kernels")
    # the teacher-forced plain forward over the prompt and the tokens
    # generated replays decode's routes: decode step t routes the B
    # streams' token t as one group, layer by layer; the forward routes
    # all B * T tokens (stream-major) as one group; nothing is dropped at
    # this capacity in either
    T = S + new - 1
    L = len(dec) // T
    if L * T != len(dec):
        raise AssertionError(f"{len(dec)} moe calls in {T} decode steps")
    forced = [{key: torch.stack([dec[t * L + layer][key][0]
                                 for t in range(T)], 1).reshape(
                                     1, B * T, -1)
               for key in ("probs", "idx")} for layer in range(L)]
    seq = torch.cat([prompts, out["no-drop"][:, :-1]], dim=1)
    with torch.no_grad(), moe_routes(forced) as fwd:
        logits, _ = backbone.forward(params, {"tokens": seq}, nodrop,
                                     use_kernel=False)
    _, route_line = replayed(fwd, cfg, torch.float32)
    want = logits[:, S - 1:].argmax(-1)
    top = torch.topk(logits[:, S - 1:], 2, dim=-1).values
    # each position is held on its own: the forward reads the tokens
    # decode generated and routes as decode did
    held = (top[..., 0] - top[..., 1]) > 2e-3
    wrong = held & (out["no-drop"] != want)
    if wrong.any() or int(held.sum()) < MOE_GEN_HELD:
        raise AssertionError(
            f"moe generate (no drop): {int(wrong.sum())} of "
            f"{int(held.sum())} held tokens differ from the teacher-forced "
            f"plain forward's argmax ({out['no-drop'].tolist()} vs "
            f"{want.tolist()}; at least {MOE_GEN_HELD} held)")
    parted = int((out["real"] != out["no-drop"]).sum())
    log(f"moe generate {DS_ARCH}: {B} prompts of {S} tokens, {new} new each, "
        f"greedy, the prompt replayed through decode_step, no launch; at "
        f"the real capacity {out['real'].tolist()} ({out['real_s']:.4f} s, "
        f"{B * (S + new) / out['real_s']:.1f} replayed and generated "
        f"tokens/s); at capacity factor {MOE_NO_DROP} "
        f"{out['no-drop'].tolist()} ({out['no-drop_s']:.4f} s), "
        f"{int(held.sum())} of {B * new} tokens held (a top-2 gap above "
        f"2e-3; at least {MOE_GEN_HELD}) equal to the argmax of the "
        f"teacher-forced plain forward, which {route_line}; {parted} tokens "
        f"differ between the two capacities (decode routes the batch as one "
        f"group of capacity {moe_lib._capacity(B, cfg.moe)}) | {card}")
    del params, logits
    torch.cuda.empty_cache()
    return launches


def deepseek_train(card: str) -> dict:
    """(c) deepseek-moe-16b at full width cut to MOE_TRAIN_LAYERS layers (2
    dense tower layers, 4 MoE server layers; AdamW updates in place), K =
    4, avg, ``train_split`` over
    inproc, serial, 8 x 256 tokens, MOE_TRAIN_STEPS steps, step 0 verified
    against ``protocol_step`` at 1e-5.  Counters reset just before the run
    and read just after: one avg merge each way a step at (4, 2048, 2048)
    on the merge kernels, no flash (256 tokens).  Every step's ledger
    equals the byte models, its ``aux_loss`` slot
    ``costs.aux_exchange_bytes``.  Returns the launches."""
    cfg = dataclasses.replace(get_arch(DS_ARCH), num_layers=MOE_TRAIN_LAYERS)
    v = cfg.vertical
    torch.cuda.empty_cache()
    with merge_calls() as merges:
        _, metrics, seconds, launches, peak = train(cfg, MOE_TRAIN_STEPS,
                                                    "cuda")
    expect_launches(launches, {"merge_reduce_kernel": MOE_TRAIN_STEPS,
                               "merge_reduce_bwd_kernel": MOE_TRAIN_STEPS})
    if merges != [("avg", MOE_TRAIN_SHAPE)] * MOE_TRAIN_STEPS:
        raise AssertionError(f"moe train: role 0 merged {merges}")
    if metrics.step0_max_dgrad is None or metrics.step0_max_dgrad > 1e-5:
        raise AssertionError(f"moe train: step 0 not verified "
                             f"({metrics.step0_max_dgrad})")
    rows = TRAIN_BATCH * TRAIN_SEQ
    aux = costs.aux_exchange_bytes(1)
    want = (2 * v.num_clients * costs.cut_bytes(rows, cfg.d_model)
            + 2 * costs.head_exchange_bytes(rows, cfg.vocab_size) + aux)
    got = [(ledger.total(), ledger.bytes_with_tag("aux_loss"))
           for ledger in metrics.ledgers]
    if got != [(want, aux)] * MOE_TRAIN_STEPS:
        raise AssertionError(f"moe train: ledgers {got} != costs "
                             f"{(want, aux)}")
    if len(metrics.aux_losses) != MOE_TRAIN_STEPS or not all(
            math.isfinite(a) and a > 0 for a in metrics.aux_losses):
        raise AssertionError(f"moe train: aux {metrics.aux_losses}")
    steady = metrics.step_times[1:]
    log(f"moe train: {DS_ARCH} full width at {cfg.num_layers} layers (K="
        f"{v.num_clients} dense towers of {v.tower_layers}, "
        f"{backbone.param_count(cfg)} params), f32, serial, "
        f"{MOE_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
        f"losses {metrics.losses}, router aux {metrics.aux_losses}, step-0 "
        f"max |dgrad| vs protocol_step {metrics.step0_max_dgrad:.3e} (<= "
        f"1e-5); merges avg {MOE_TRAIN_SHAPE} one each way a step; ledger "
        f"{want} bytes a step = costs, {aux} of them the aux_loss slot = "
        f"costs.aux_exchange_bytes(1); launches "
        f"{ {k: n for k, n in launches.items() if n} }; "
        f"{len(steady) * rows / sum(steady):.1f} train tokens/s over steps "
        f"1-{MOE_TRAIN_STEPS - 1} (step times {metrics.step_times} s; step "
        f"0 includes the verification), wall {seconds:.4f} s with set-up, "
        f"max_memory_allocated {peak} bytes | {card}")
    return launches


def arctic_forward(card: str) -> dict:
    """(d) arctic-480b at published widths cut to AR_LAYERS layers (2 dense
    tower layers, 2 MoE server layers of 128 experts top-2 beside a dense
    residual), bf16 (every expert stack drawn matrix by matrix: the init
    holds no f32 copy of a stack): ``forward`` of one 4096-token prompt
    on the kernels and on the plain path, 10 flash launches at D = 128 in
    bf16 (2 server at 56 / 8 heads, 4 x 2 tower at 14 / 2).  Returns the
    launches."""
    cfg = dataclasses.replace(get_arch(AR_ARCH), num_layers=AR_LAYERS)
    params, init_line = init_on_card(cfg, torch.bfloat16)
    if params["server"]["moe"]["router"].dtype != torch.float32:
        raise AssertionError("arctic router not f32")
    K = cfg.vertical.num_clients
    n = moe_flash_counts(cfg)
    log(f"moe model: {AR_ARCH} at published widths cut to {cfg.num_layers} "
        f"layers (d_model {cfg.d_model}, {cfg.moe.num_experts} experts of "
        f"d_ff {cfg.d_ff} top-{cfg.moe.top_k}, dense residual "
        f"{cfg.moe.d_ff_dense_residual}; attention {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim()}, towers "
        f"{cfg.num_heads // K}/{cfg.num_kv_heads // K}), K={K}, bf16 "
        f"(router f32): {init_line}")
    rng = np.random.default_rng(SEED)
    warm = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 256)),
                           device="cuda")
    with torch.no_grad():
        backbone.forward(params, {"tokens": warm}, cfg)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, MOE_PREFILL)), device="cuda")
    launches, line = moe_forward_runs(cfg, params, tokens, torch.bfloat16)
    expect_launches(launches, {"flash_attention_kernel": n,
                               flash_name(128): n,
                               flash_name(128, torch.bfloat16): n})
    log(f"moe forward {AR_ARCH} (1, {MOE_PREFILL}), bf16: {line} | {card}")
    del params
    torch.cuda.empty_cache()
    return launches


def cbp_against_cpu(card: str) -> None:
    """(e) ``merge_cbp`` of K = 4 cuts ``CBP_SHAPE`` into ``CBP_OUT``
    features, client 1 dropped, on the card against the CPU (same sketch
    from a CPU generator), timed (plain PyTorch on both devices: the
    reference has no kernel).  The output is the signed square root of
    the sketches' spectral product, L2-normalised, so ``sign(out) *
    out**2`` is that product over its row's L1 norm: held within 1e-5 of
    its largest entry.  The output itself is held within 1e-5 of its
    largest entry wherever that product is above ``CBP_ROOT_FLOOR`` of
    its row's largest: below it the signed square root magnifies the
    FFTs' roundings (by up to 5e3 at zero), and those elements are counted
    and their worst difference printed."""
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    K, rows, D = CBP_SHAPE
    sketch = bilinear.CountSketch.create(gen, K, D, CBP_OUT)
    cuts = torch.randn(CBP_SHAPE, generator=gen)
    live = torch.ones(K)
    live[1] = 0.0
    sk_card = bilinear.CountSketch(sketch.signs.cuda(), sketch.buckets.cuda(),
                                   CBP_OUT)
    t0 = time.perf_counter()
    want = bilinear.merge_cbp(cuts, sketch, live_mask=live)
    cpu_s = time.perf_counter() - t0
    args = (cuts.cuda(), live.cuda())
    got = bilinear.merge_cbp(args[0], sk_card, live_mask=args[1]).cpu()
    pre, pre_want = (torch.sign(x) * x * x for x in (got, want))
    pre_diff = float((pre - pre_want).abs().max())
    pre_scale = float(pre_want.abs().max())
    held = pre_want.abs() >= CBP_ROOT_FLOOR * pre_want.abs().amax(
        -1, keepdim=True)
    err = (got - want).abs()
    diff = float(err[held].max())
    rest = float(err[~held].max()) if (~held).any() else 0.0
    scale = float(want.abs().max())
    if got.shape != (rows, CBP_OUT) or pre_diff > 1e-5 * pre_scale or \
            diff > 1e-5 * scale:
        raise AssertionError(
            f"merge_cbp: card vs CPU product {pre_diff:.3e} (tol 1e-5 x "
            f"{pre_scale:.3e}), output {diff:.3e} (tol 1e-5 x {scale:.3e})")
    ms = time_ms(lambda c, lv: bilinear.merge_cbp(c, sk_card, live_mask=lv),
                 [args], iters=20)
    log(f"merge_cbp: K={K} cuts {CBP_SHAPE} -> ({rows}, {CBP_OUT}), client 1 "
        f"dropped (the mean sketch of the live ones), card vs CPU: the "
        f"spectral product over its row's L1 norm (sign(out) * out^2) "
        f"within {pre_diff:.3e} (<= 1e-5 x its largest {pre_scale:.3e}); "
        f"the output within {diff:.3e} (<= 1e-5 x its largest {scale:.3e}) "
        f"at the {int(held.sum())} of {held.numel()} elements whose product "
        f"is >= {CBP_ROOT_FLOOR:g} of its row's largest, {rest:.3e} at the "
        f"other {int((~held).sum())} (the signed root near zero); per call "
        f"{ms:.4f} ms on the card, {cpu_s * 1e3:.1f} ms once on the CPU | "
        f"{card}")


def moe_phase(card: str) -> dict:
    """Phase 17; returns the launches by sub-phase: ``"deepseek_forward"``,
    ``"deepseek_train"``, ``"arctic_forward"``."""
    t0 = time.perf_counter()
    moe_small_against_cpu()
    out = {"deepseek_forward": deepseek_full(card),
           "deepseek_train": deepseek_train(card),
           "arctic_forward": arctic_forward(card)}
    cbp_against_cpu(card)
    log(f"moe: phase 17 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 18: the audio and vlm families
# ---------------------------------------------------------------------------

def _loader_batch(cfg, batch: int, seq: int, device) -> dict:
    """One loader batch on ``device``."""
    b = next(iter(LMBatchLoader(cfg, batch, seq, seed=SEED)))
    return {k: to_tensor(v, device) for k, v in b.items()}


def modality_prefill(cfg, params, cache, batch: dict) -> dict:
    """The family's modality prefill: the encoder's cross K/V (audio) or
    the vision prefix (vlm)."""
    if cfg.family == "audio":
        return backbone.prefill_cross_attention(params, cache,
                                                batch["frames"], cfg)
    return backbone.prefill_vision(params, cache, batch["patches"], cfg)


def modality_small_against_cpu() -> dict:
    """(a) Reduced whisper-tiny and internvl2-26b, same weights, the card
    against the CPU: ``forward`` logits, the modality prefill plus 4
    ``decode_step``s (logits within 1e-4, no launch at these lengths),
    then 2 steps of ``train_split`` over inproc on each, step 0 verified
    in each run at 1e-5, losses and final params within 1e-4 (whisper's
    merges on the reduce kernels, one each way a step; vlm's sequence
    concatenation launches none).  Returns the card runs' launches."""
    total: dict = {}
    for arch, seq in ((WH_ARCH, 16), (VL_ARCH, 24)):
        cfg = get_arch(arch).reduced()
        gen = torch.Generator(device="cpu").manual_seed(SEED)
        cpu_params = backbone.init_params(cfg, gen, device="cpu")
        out = {}
        for device, params in (("cuda", _to(cpu_params, "cuda")),
                               ("cpu", cpu_params)):
            batch = _loader_batch(cfg, 2, seq, device)
            reset_launches()
            with torch.no_grad():
                logits, _ = backbone.forward(params, batch, cfg)
                cache = modality_prefill(cfg, params, backbone.init_cache(
                    cfg, 2, seq + 4, device=device), batch)
                steps = []
                for t in range(4):
                    step_logits, cache = backbone.decode_step(
                        params, cache, batch["tokens"][:, t], cfg)
                    steps.append(step_logits)
            launches = read_launches()
            if any(launches.values()):
                raise AssertionError(f"reduced {arch}: the forward and decode "
                                     f"launched kernels: {launches}")
            out[device] = (logits.cpu(), torch.stack(steps, 1).cpu())
        fwd = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        dec = float((out["cuda"][1] - out["cpu"][1]).abs().max())
        if not torch.isfinite(out["cuda"][0]).all() or fwd > 1e-4 or \
                dec > 1e-4:
            raise AssertionError(f"reduced {arch}: card logits differ from "
                                 f"the CPU's by {fwd:.3e} (forward), {dec:.3e} "
                                 "(prefill + decode); tol 1e-4")
        runs = {}
        for device, params in (("cpu", cpu_params),
                               ("cuda", _to(cpu_params, "cuda"))):
            run_out, metrics, _, launches, _ = train(
                cfg, 2, device, params=params, batch=4, seq=seq,
                print_fn=lambda *a: None)
            if metrics.step0_max_dgrad is None or \
                    metrics.step0_max_dgrad > 1e-5:
                raise AssertionError(f"reduced {arch} on {device}: step 0 "
                                     f"{metrics.step0_max_dgrad}")
            runs[device] = (run_out, metrics)
        merges = 2 if cfg.family == "audio" else 0
        expect_launches(launches, {"merge_reduce_kernel": merges,
                                   "merge_reduce_bwd_kernel": merges})
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        losses = [m.losses for _, m in (runs["cuda"], runs["cpu"])]
        worst = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            _leaves(runs["cuda"][0]), _leaves(runs["cpu"][0])))
        loss_diff = max(abs(a - b) for a, b in zip(*losses))
        if loss_diff > 1e-4 or worst > 1e-4:
            raise AssertionError(f"reduced {arch} training: card vs CPU "
                                 f"losses {loss_diff:.3e}, params "
                                 f"{worst:.3e} > 1e-4")
        log(f"small modality {arch}: reduced ({cfg.num_layers} layers, "
            f"d_model {cfg.d_model}) on the card matches the CPU path: "
            f"forward of 2 x {seq} logits max |diff| {fwd:.3e}, modality "
            f"prefill + 4 decode steps {dec:.3e} (<= 1e-4, no launch); 2 "
            f"train_split steps over inproc: step-0 max |dgrad| vs "
            f"protocol_step {runs['cuda'][1].step0_max_dgrad:.3e} (card), "
            f"{runs['cpu'][1].step0_max_dgrad:.3e} (CPU) (<= 1e-5), losses "
            f"{losses[0]} vs {losses[1]} (max |diff| {loss_diff:.3e}), final "
            f"params max |diff| {worst:.3e} (<= 1e-4); launches "
            f"{ {k: n for k, n in launches.items() if n} }")
    return total


def whisper_full(card: str) -> dict:
    """(b) whisper-tiny at full width, f32: ``forward`` of 8 x (1500
    frames, 448 tokens), no kernel (no attention reaches 2048 x 2048 and
    the monolithic merge is plain); then ``init_cache`` ->
    ``prefill_cross_attention`` -> 448 teacher-forced ``decode_step``s,
    each step's logits within DECODE_EQUIV_TOL of the forward's; then 32
    greedy tokens.  Counters reset just before and read just after each
    run.  Returns the launches."""
    cfg = get_arch(WH_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = backbone.init_params(cfg, gen, device="cuda")
    if sum(t.numel() for t in _leaves(params)) != backbone.param_count(cfg):
        raise AssertionError("whisper-tiny: param count")
    frames = frontend.synth_audio_frames(gen, WH_BATCH, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (WH_BATCH, WH_TEXT),
                           generator=gen, device="cuda")
    batch = {"frames": frames, "tokens": tokens}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        full, _ = backbone.forward(params, batch, cfg)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    launches = read_launches()
    if not torch.isfinite(full).all():
        raise AssertionError("whisper-tiny: non-finite forward logits")
    reset_launches()
    t0 = time.perf_counter()
    worst, scale = 0.0, 0.0
    with torch.no_grad():
        cache = backbone.prefill_cross_attention(
            params, backbone.init_cache(cfg, WH_BATCH, WH_TEXT + WH_GEN,
                                        device="cuda"), frames, cfg)
        for t in range(WH_TEXT):
            logits, cache = backbone.decode_step(params, cache,
                                                 tokens[:, t], cfg)
            want = full[:, t]
            excess = (logits - want).abs() - DECODE_EQUIV_TOL * want.abs()
            worst = max(worst, float((logits - want).abs().max()))
            if float(excess.max()) > DECODE_EQUIV_TOL:
                raise AssertionError(
                    f"whisper-tiny decode step {t}: logits differ from the "
                    f"forward's by {float((logits - want).abs().max()):.3e} "
                    f"(rtol and atol {DECODE_EQUIV_TOL})")
            scale = max(scale, float(want.abs().max()))
        torch.cuda.synchronize()
        t_replay = time.perf_counter() - t0
        t0 = time.perf_counter()
        new = []
        for i in range(WH_GEN):
            tok = torch.argmax(logits, dim=-1)
            new.append(tok)
            if i + 1 < WH_GEN:
                logits, cache = backbone.decode_step(params, cache, tok, cfg)
        torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    dec_launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()) or any(dec_launches.values()):
        raise AssertionError(f"whisper-tiny launched kernels: {launches}, "
                             f"{dec_launches}")
    gen_tokens = torch.stack(new, 1).cpu()
    log(f"whisper full: {WH_ARCH} full width ({backbone.param_count(cfg)} "
        f"params, f32; K={cfg.vertical.num_clients} mel-band towers of "
        f"{cfg.vertical.tower_layers}, avg): forward of {WH_BATCH} x "
        f"({cfg.encdec.encoder_seq_len} frames, {WH_TEXT} tokens) "
        f"{WH_BATCH * WH_TEXT / t_fwd:.1f} decoder tokens/s ({t_fwd:.4f} s, "
        f"no launch: encoder 1500^2 and cross 448 x 1500 under 2048^2); "
        f"cross prefill + {WH_TEXT} teacher-forced decode steps "
        f"{WH_BATCH * WH_TEXT / t_replay:.1f} tokens/s ({t_replay:.4f} s), "
        f"logits within {worst:.3e} of the forward's (largest "
        f"{scale:.3e}; rtol and atol {DECODE_EQUIV_TOL}); {WH_GEN} greedy "
        f"tokens {WH_BATCH * WH_GEN / t_gen:.1f} tokens/s ({t_gen:.4f} s; "
        f"first stream {gen_tokens[0, :8].tolist()}...); "
        f"max_memory_allocated {peak} bytes | {card}")
    del params, cache, full
    return {k: launches[k] + dec_launches[k] for k in launches}


def whisper_train(card: str) -> dict:
    """(c) whisper-tiny split training: K = 2 mel-band towers of one
    encoder layer, avg, ``train_split`` over inproc, serial, 8 x (1500
    frames, 448 tokens), WH_TRAIN_STEPS steps, step 0 verified against
    ``protocol_step`` at 1e-5; role 0's server takes the batch's tokens
    (``server_takes_batch``).  Counters reset just before the run and read
    just after: one avg merge each way a step at (2, 12000, 384) on the
    merge kernels, no flash.  Every step's ledger equals the byte models.
    Returns the launches."""
    cfg = get_arch(WH_ARCH)
    v = cfg.vertical
    torch.cuda.empty_cache()
    with merge_calls() as merges:
        _, metrics, seconds, launches, peak = train(
            cfg, WH_TRAIN_STEPS, "cuda", batch=WH_BATCH, seq=WH_TEXT)
    expect_launches(launches, {"merge_reduce_kernel": WH_TRAIN_STEPS,
                               "merge_reduce_bwd_kernel": WH_TRAIN_STEPS})
    if merges != [("avg", WHISPER_TRAIN_SHAPE)] * WH_TRAIN_STEPS:
        raise AssertionError(f"whisper train: role 0 merged {merges}")
    if metrics.step0_max_dgrad is None or metrics.step0_max_dgrad > 1e-5:
        raise AssertionError(f"whisper train: step 0 not verified "
                             f"({metrics.step0_max_dgrad})")
    rows = WH_BATCH * WH_TEXT
    want = (2 * v.num_clients * costs.cut_bytes(
        WH_BATCH * cfg.encdec.encoder_seq_len, cfg.d_model)
        + 2 * costs.head_exchange_bytes(rows, cfg.vocab_size))
    got = [ledger.total() for ledger in metrics.ledgers]
    if got != [want] * WH_TRAIN_STEPS:
        raise AssertionError(f"whisper train: ledgers {got} != costs {want}")
    steady = metrics.step_times[1:]
    log(f"whisper train: {WH_ARCH} full width, f32, serial, "
        f"{WH_TRAIN_STEPS} steps of {WH_BATCH} x ({cfg.encdec.encoder_seq_len}"
        f" frames, {WH_TEXT} tokens): losses {metrics.losses}, step-0 max "
        f"|dgrad| vs protocol_step {metrics.step0_max_dgrad:.3e} (<= 1e-5); "
        f"merges avg {WHISPER_TRAIN_SHAPE} one each way a step; ledger "
        f"{want} bytes a step = costs; launches "
        f"{ {k: n for k, n in launches.items() if n} }; "
        f"{len(steady) * rows / sum(steady):.1f} train decoder tokens/s "
        f"over steps 1-{WH_TRAIN_STEPS - 1} (step times "
        f"{metrics.step_times} s; step 0 includes the verification), wall "
        f"{seconds:.4f} s with set-up, max_memory_allocated {peak} bytes | "
        f"{card}")
    return launches


def internvl_full(card: str) -> dict:
    """(d) internvl2-26b at full width in bf16: ``forward`` of 1024 patches
    and VL_TEXT text tokens on the kernels and on the plain path, the
    counters reset just before each and read just after: 48 flash
    launches at D = 128 in bf16 (47 server layers at 4096 tokens, the text
    tower at 3072 from position 1024; the 1024-patch vision tower stays
    under the threshold), none on the plain path; every position's logits
    within PLAIN_BF16_TOL of its largest plain logit.  Then ``init_cache``
    -> ``prefill_vision`` -> VL_REPLAY text tokens replayed through
    ``decode_step`` (each step within PLAIN_BF16_TOL of the forward's
    largest logit at that position) and VL_GEN greedy tokens.  Returns the
    kernel forward's launches."""
    cfg = get_arch(VL_ARCH)
    params, init_line = init_on_card(cfg, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    patches = frontend.synth_vision_patches(gen, 1, cfg, torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (1, VL_TEXT), generator=gen,
                           device="cuda")
    batch = {"patches": patches, "tokens": tokens}
    runs = {}
    for use_kernel in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = backbone.forward(params, batch, cfg,
                                         use_kernel=use_kernel)
        torch.cuda.synchronize()
        runs[use_kernel] = (logits, time.perf_counter() - t0,
                            read_launches(), torch.cuda.max_memory_allocated())
    (got, t_k, launches, peak), (want, t_p, plain_launches, ppeak) = \
        runs[True], runs[False]
    n_server = backbone._server_layers(cfg)
    n_flash = n_server + cfg.vertical.tower_layers  # the text tower's too
    expect_launches(launches, {"flash_attention_kernel": n_flash,
                               flash_name(128): n_flash,
                               flash_name(128, torch.bfloat16): n_flash})
    if any(plain_launches.values()):
        raise AssertionError(f"internvl plain forward launched "
                             f"{plain_launches}")
    if not torch.isfinite(got).all():
        raise AssertionError("internvl: non-finite logits")
    V = want.shape[-1]
    a, b = got.reshape(-1, V).float(), want.reshape(-1, V).float()
    rel = float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())
    if rel > PLAIN_BF16_TOL:
        raise AssertionError(f"internvl kernel vs plain: a position is "
                             f"{rel:.3e} of its largest logit apart (tol "
                             f"{PLAIN_BF16_TOL})")
    del want, runs, a, b
    Sv = cfg.vlm.num_vision_tokens
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    worst = 0.0
    with torch.no_grad():
        cache = backbone.prefill_vision(
            params, backbone.init_cache(cfg, 1, Sv + VL_REPLAY + VL_GEN,
                                        dtype=torch.bfloat16, device="cuda"),
            patches, cfg)
        for t in range(VL_REPLAY):
            logits, cache = backbone.decode_step(params, cache,
                                                 tokens[:, t], cfg)
            ref_t = got[:, t].float()
            worst = max(worst, float((logits.float() - ref_t).abs().max()
                                     / ref_t.abs().max()))
        torch.cuda.synchronize()
        t_replay = time.perf_counter() - t0
        t0 = time.perf_counter()
        new = []
        for i in range(VL_GEN):
            tok = torch.argmax(logits, dim=-1)
            new.append(tok)
            if i + 1 < VL_GEN:
                logits, cache = backbone.decode_step(params, cache, tok, cfg)
        torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    dec_launches = read_launches()
    dec_peak = torch.cuda.max_memory_allocated()
    if worst > PLAIN_BF16_TOL or any(dec_launches.values()):
        raise AssertionError(f"internvl replay: logits {worst:.3e} of the "
                             f"forward's largest apart (tol "
                             f"{PLAIN_BF16_TOL}); launches {dec_launches}")
    S = Sv + VL_TEXT
    log(f"internvl full: {VL_ARCH} full width, bf16, {init_line}; forward "
        f"of {Sv} patches + {VL_TEXT} text tokens: kernel "
        f"{S / t_k:.1f} positions/s ({VL_TEXT / t_k:.1f} text tokens/s, "
        f"{t_k:.4f} s, launches "
        f"{ {k: n for k, n in launches.items() if n} }: {n_server} server "
        f"layers at {S} and the text tower at {VL_TEXT} from position {Sv}, "
        f"{cfg.num_heads} q / {cfg.num_kv_heads} kv heads, "
        f"max_memory_allocated {peak} bytes); plain "
        f"{S / t_p:.1f} positions/s ({t_p:.4f} s, no launch, "
        f"max_memory_allocated {ppeak} bytes); every position within "
        f"{rel:.3e} of its largest plain logit (tol {PLAIN_BF16_TOL}); "
        f"prefill_vision + {VL_REPLAY} replayed text tokens "
        f"{VL_REPLAY / t_replay:.1f} tokens/s ({t_replay:.4f} s; each step "
        f"within {worst:.3e} of the forward's largest, tol "
        f"{PLAIN_BF16_TOL}), {VL_GEN} greedy {VL_GEN / t_gen:.1f} tokens/s "
        f"({t_gen:.4f} s; {torch.stack(new, 1)[0].tolist()}), "
        f"max_memory_allocated {dec_peak} bytes | {card}")
    del params, cache, got
    torch.cuda.empty_cache()
    return launches


def internvl_train(card: str) -> dict:
    """(e) internvl2-26b at full width cut to VL_TRAIN_LAYERS layers (the
    vision and the text tower one layer each, 3 server layers), f32, K =
    2 modalities, ``train_split`` over inproc, serial, VL_TRAIN_BATCH x
    (1024 patches + 256 text tokens), VL_TRAIN_STEPS steps, step 0
    verified against ``protocol_step`` at 1e-5.  The Executor merges the
    two cuts with the program's ``merge_fn`` (a sequence concatenation:
    no kernel) and hands each modality its segment's gradient; 1280
    positions keep every attention under the flash threshold.  Counters
    reset just before the run and read just after: no launch, no
    ``fast_merge``.  Every step's ledger equals the byte models (each
    modality's cut at its own length).  Returns the launches."""
    cfg = dataclasses.replace(get_arch(VL_ARCH), num_layers=VL_TRAIN_LAYERS)
    Sv = cfg.vlm.num_vision_tokens
    torch.cuda.empty_cache()
    with merge_calls() as merges:
        _, metrics, seconds, launches, peak = train(
            cfg, VL_TRAIN_STEPS, "cuda", batch=VL_TRAIN_BATCH,
            seq=VL_TRAIN_SEQ)
    expect_launches(launches, {})
    if merges:
        raise AssertionError(f"internvl train: role 0 fast-merged {merges}")
    if metrics.step0_max_dgrad is None or metrics.step0_max_dgrad > 1e-5:
        raise AssertionError(f"internvl train: step 0 not verified "
                             f"({metrics.step0_max_dgrad})")
    text = VL_TRAIN_SEQ - Sv
    want = (2 * (costs.cut_bytes(VL_TRAIN_BATCH * Sv, cfg.d_model)
                 + costs.cut_bytes(VL_TRAIN_BATCH * text, cfg.d_model))
            + 2 * costs.head_exchange_bytes(VL_TRAIN_BATCH * text,
                                            cfg.vocab_size))
    got = [ledger.total() for ledger in metrics.ledgers]
    if got != [want] * VL_TRAIN_STEPS:
        raise AssertionError(f"internvl train: ledgers {got} != costs "
                             f"{want}")
    steady = metrics.step_times[1:]
    rows = VL_TRAIN_BATCH * VL_TRAIN_SEQ
    log(f"internvl train: {VL_ARCH} full width at {cfg.num_layers} layers "
        f"({backbone.param_count(cfg)} params: vision and text towers of "
        f"{cfg.vertical.tower_layers}, {backbone._server_layers(cfg)} server "
        f"layers), "
        f"f32, serial, {VL_TRAIN_STEPS} steps of {VL_TRAIN_BATCH} x ({Sv} "
        f"patches + {text} text tokens): losses {metrics.losses}, step-0 "
        f"max |dgrad| vs protocol_step {metrics.step0_max_dgrad:.3e} (<= "
        f"1e-5); merge_fn sequence concat, no kernel; ledger {want} bytes a "
        f"step = costs; {len(steady) * rows / sum(steady):.1f} train "
        f"positions/s ({len(steady) * VL_TRAIN_BATCH * text / sum(steady):.1f}"
        f" text tokens/s) over steps 1-{VL_TRAIN_STEPS - 1} (step times "
        f"{metrics.step_times} s; step 0 includes the verification), wall "
        f"{seconds:.4f} s with set-up, max_memory_allocated {peak} bytes | "
        f"{card}")
    return launches


def modality_phase(card: str) -> dict:
    """Phase 18; returns the launches by sub-phase: ``"small"``,
    ``"whisper_forward"``, ``"whisper_train"``, ``"internvl_forward"``,
    ``"internvl_train"``."""
    t0 = time.perf_counter()
    out = {"small": modality_small_against_cpu(),
           "whisper_forward": whisper_full(card),
           "whisper_train": whisper_train(card),
           "internvl_forward": internvl_full(card),
           "internvl_train": internvl_train(card)}
    log(f"modality: phase 18 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 19: training past 2048 tokens — the flash backward
# ---------------------------------------------------------------------------

def _flash_bwd_args(shape, dtype, gen, causal=True):
    """The backward's arguments as a training step hands them over: q, k,
    v in the model's layout, the kernel forward's output and logsumexp,
    and a random output gradient."""
    q, k, v = _flash_inputs(shape, dtype, gen, True)
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
    return q, k, v, o, lse, do


def _flash_bwd_rel(got, want) -> list:
    """Each gradient's largest |kernel - plain| over its largest plain
    entry; raises on a wrong shape or dtype or a non-finite value."""
    errs = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype or \
                not torch.isfinite(g.float()).all():
            raise AssertionError(f"flash bwd {name}: {tuple(g.shape)} "
                                 f"{g.dtype}, finite "
                                 f"{bool(torch.isfinite(g.float()).all())}")
        errs.append(float((g.float() - w.float()).abs().max())
                    / float(w.float().abs().max()))
    return errs


def check_flash_bwd_kernel() -> dict:
    """(a) Every backward instantiation (D 32-128 x f32 / bf16) at 2304
    tokens, causal and full, against ref.flash_attention_bwd; the
    forward's logsumexp against ref.flash_attention_lse; two launches
    bit-identical at the server's training shape.  Fails first on a
    spill, a ptxas note that the wgmmas are serialized, or an
    instantiation of dkdv or dq without HGMMA in its SASS; prints the
    launch plan at the training shapes.  Returns the worst share of each
    gradient's largest entry by dtype and the worst f32 |error|."""
    for kernel in fa.BWD_KERNELS:
        log(f"flash bwd: {kernel} ptxas: {ptxas_report(kernel)}")
        counts = _ptxas_counts(kernel)
        if not counts or any(spill for _, spill in counts.values()):
            raise AssertionError(f"{kernel}: no ptxas report, or a spill: "
                                 f"{counts}")
    notes = {}
    for line in fa.build.library_path().with_suffix(".log").read_text(
            ).splitlines():
        code = re.search(r"\((C75\d\d)\)", line)
        if code and "flash_attention_bwd" in line:
            notes[code[1]] = notes.get(code[1], 0) + 1
    log(f"flash bwd: ptxas notes on wgmma by code (C7511, C7512, C7515 and "
        f"C7520: the wgmmas are serialized): {notes}")
    if any(notes.get(code) for code in ("C7511", "C7512", "C7515", "C7520")):
        raise AssertionError(f"flash bwd kernels: ptxas serialized their "
                             f"wgmmas: {notes}")
    for kernel in fa.BWD_KERNELS[1::2]:  # dkdv and dq
        counts = tensor_core_instructions(kernel)
        if counts is None:
            log("flash bwd: SASS not read: no cuobjdump in the CUDA toolkit "
                "or in Triton's package")
            continue
        log(f"flash bwd: HGMMA instructions in the SASS of each "
            f"{kernel} instantiation: {sorted(counts.values())}")
        expected = len(fa.HEAD_DIMS) * len(fa.DTYPE_CODES)
        if len(counts) != expected or not all(counts.values()):
            raise AssertionError(f"{kernel}: {len(counts)} instantiations "
                                 f"(expected {expected}), some without "
                                 f"tensor-core instructions: {counts}")
    for shape in FLASH_TRAIN_SHAPES:
        plan = fa.bwd_plan(*shape, torch.float32, torch.device("cuda", 0))
        log(f"flash bwd plan at {shape} f32 on {plan['sms']} SMs: dkdv and "
            f"dq each {plan['blocks']} blocks of {plan['block_rows']} rows "
            f"({plan['waves']:.2f} waves, the longest {plan['longest_tiles']} "
            f"tiles of {plan['tile_rows']} rows; {plan['dkdv_smem']} and "
            f"{plan['dq_smem']} B of shared memory), the reduce "
            f"{plan['reduce_blocks']} blocks summing "
            f"{plan['heads_per_sum']} heads a kv head")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_abs, worst_lse, n = 0.0, 0.0, 0
    for D in fa.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                shape = (1, 6, 2, FLASH_BWD_S, D)
                args = _flash_bwd_args(shape, dtype, gen, causal)
                got = fa.flash_attention_bwd(*args, causal=causal)
                want = ref.flash_attention_bwd(*args, causal=causal)
                _, lse = ref.flash_attention_lse(*args[:3], causal=causal)
                torch.cuda.synchronize()
                errs = _flash_bwd_rel(got, want)
                if max(errs) > FLASH_BWD_REL[dtype]:
                    raise AssertionError(
                        f"flash bwd {shape} {dtype} causal={causal}: dq, dk, "
                        f"dv off by {errs} of their largest entries > "
                        f"{FLASH_BWD_REL[dtype]}")
                worst[dtype] = max(worst[dtype], *errs)
                if dtype == torch.float32:
                    worst_abs = max(worst_abs, *(
                        float((g - w).abs().max()) for g, w in zip(got,
                                                                   want)))
                lse_err = float((args[4] - lse).abs().max())
                if lse_err > FLASH_LSE_TOL:
                    raise AssertionError(f"flash lse {shape} {dtype}: "
                                         f"{lse_err:.3e} > {FLASH_LSE_TOL}")
                worst_lse = max(worst_lse, lse_err)
                n += 1
                del args, got, want, lse
    for dtype in (torch.float32, torch.bfloat16):
        args = _flash_bwd_args(FLASH_TRAIN_SHAPES[0], dtype, gen)
        first = fa.flash_attention_bwd(*args, causal=True)
        second = fa.flash_attention_bwd(*args, causal=True)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"flash bwd {FLASH_TRAIN_SHAPES[0]} {dtype}: "
                                 "two launches differ")
        del args, first, second
    torch.cuda.empty_cache()
    log(f"flash bwd kernels: {n} cases (B, H, Hkv, S, D) = (1, 6, 2, "
        f"{FLASH_BWD_S}, D) for D in {fa.HEAD_DIMS}, f32 and bf16, causal "
        f"and full, match ref.flash_attention_bwd: worst share of a "
        f"gradient's largest entry f32 {worst[torch.float32]:.3e} (<= "
        f"{FLASH_BWD_REL[torch.float32]}), bf16 "
        f"{worst[torch.bfloat16]:.3e} (<= "
        f"{FLASH_BWD_REL[torch.bfloat16]}); worst f32 |err| "
        f"{worst_abs:.3e}; the forward's lse within {worst_lse:.3e} of "
        f"the plain one (<= {FLASH_LSE_TOL}); two launches at "
        f"{FLASH_TRAIN_SHAPES[0]} bit-identical in f32 and bf16")
    return {"rel": worst, "abs": worst_abs, "lse": worst_lse}


def flash_bwd_bound(B, H, Hkv, S, D, causal=True) -> tuple:
    """Least time on an H100 SXM for one backward call: five D-deep
    products per attended pair (Q K^T, dO V^T, P^T dO, dS^T Q, dS K: 10 D
    flops), each in f32 as three TF32 products at the tensor cores' dense
    TF32 rate, vs the bytes (q, k, v, o, dO and lse read once, dq, dk, dv
    written once).  Also the f32-FMA figure, the flops and the design's
    own floor: seven products a pair (dq recomputes S and dP), 7/5 of the
    operations' time."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 10 * D * B * H * pairs
    nbytes = 4 * (4 * B * H * S * D + 4 * B * Hkv * S * D + B * H * S)
    t_ops, t_bytes = 3 * flops / H100_TF32_FLOPS, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            max(flops / H100_F32_FLOPS, t_bytes) * 1e3, flops,
            max(t_ops * 7 / 5, t_bytes) * 1e3)


def time_flash_bwd(card: str) -> dict:
    """The backward at FLASH_TRAIN_SHAPES (causal f32, the model's
    layout): per call and on the device, the plain backward likewise, and
    one library call: scaled_dot_product_attention's memory-efficient
    backward (kv heads repeated, which leaves the sum over each group
    undone), per call through autograd.grad of its forward and on the
    device as the aten op that autograd calls,
    ``_scaled_dot_product_efficient_attention_backward``, captured in a
    graph beside the kernels.  At these batch-2 shapes the
    kernel's gradients are held to the plain backward's within
    FLASH_BWD_REL and its forward's logsumexp to the plain one within
    FLASH_LSE_TOL; either raises.  Then the forward with and without
    its logsumexp at the same shapes and at row 5's serving shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention

    rows = {}
    for shape in FLASH_TRAIN_SHAPES:
        B, H, Hkv, S, D = shape
        gen = torch.Generator(device="cuda").manual_seed(S + H)
        args = _flash_bwd_args(shape, torch.float32, gen)
        q, k, v, _, _, do = args
        lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in
                      (q, k.repeat_interleave(H // Hkv, dim=1),
                       v.repeat_interleave(H // Hkv, dim=1)))
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            lout = scaled_dot_product_attention(lq, lk, lv, is_causal=True)
        fns = {"": lambda: fa.flash_attention_bwd(*args, causal=True),
               "plain_": lambda: ref.flash_attention_bwd(*args, causal=True)}
        row = {}
        for prefix, fn in fns.items():
            row[prefix + "ms"] = time_ms(lambda _: fn(), [(None,)], iters=10)
            row[prefix + "device_ms"] = device_ms(lambda _: fn(), [(None,)],
                                                  iters=5, reps=3)
        row["library_ms"] = time_ms(lambda _: torch.autograd.grad(
            lout, (lq, lk, lv), do, retain_graph=True), [(None,)], iters=10)
        eq, ek, ev = (t.detach().contiguous() for t in (lq, lk, lv))
        eout, elog, seed, offset = \
            torch.ops.aten._scaled_dot_product_efficient_attention(
                eq, ek, ev, None, True, 0.0, True)
        edo = do.contiguous()
        row["library_device_ms"] = device_ms(
            lambda _: torch.ops.aten.
            _scaled_dot_product_efficient_attention_backward(
                edo, eq, ek, ev, None, eout, elog, seed, offset, 0.0,
                [True, True, True, False], True), [(None,)], iters=5, reps=3)
        row["bound_ms"], row["bound_by"], row["fma_bound_ms"], flops, \
            row["floor_ms"] = flash_bwd_bound(*shape)
        row["plan"] = fa.bwd_plan(*shape, torch.float32,
                                  torch.device("cuda", 0))
        fwd = {"fwd_lse_": lambda: fa.flash_attention(q, k, v, causal=True,
                                                      return_lse=True),
               "fwd_": lambda: fa.flash_attention(q, k, v, causal=True)}
        for prefix, fn in fwd.items():
            row[prefix + "ms"] = time_ms(lambda _: fn(), [(None,)], iters=20)
            row[prefix + "device_ms"] = device_ms(lambda _: fn(), [(None,)],
                                                  iters=10, reps=3)
        got = fns[""]()
        want = fns["plain_"]()
        _, want_lse = ref.flash_attention_lse(q, k, v, causal=True)
        lgrad = torch.autograd.grad(lout, (lq, lk, lv), do)
        torch.cuda.synchronize()
        errs = _flash_bwd_rel(got, want)
        if max(errs) > FLASH_BWD_REL[torch.float32]:
            raise AssertionError(
                f"flash bwd {shape} f32: dq, dk, dv off by {errs} of their "
                f"largest plain entries > {FLASH_BWD_REL[torch.float32]}")
        lse_err = float((args[4] - want_lse).abs().max())
        if lse_err > FLASH_LSE_TOL:
            raise AssertionError(f"flash lse {shape} f32: {lse_err:.3e} > "
                                 f"{FLASH_LSE_TOL}")
        row["plain_rel_err"], row["lse_err"] = max(errs), lse_err
        lib = (lgrad[0], *(g.reshape(B, Hkv, H // Hkv, S, D).sum(2)
                           for g in lgrad[1:]))
        row["library_max_abs_diff"] = max(float((a - b).abs().max())
                                          for a, b in zip(got, lib))
        rows[shape] = row
        log(f"time flash bwd causal f32 ({B}, {H}/{Hkv}, {S}, {D}): per "
            f"call (device): kernels {row['ms']:.6f} ({row['device_ms']:.6f})"
            f" ms = {flops / row['device_ms'] / 1e9:.2f} TFLOP/s of the "
            f"function's {flops / 1e9:.3f} GFLOP "
            f"({100 * row['bound_ms'] / row['device_ms']:.1f}% of the 3xTF32 "
            f"bound, {100 * row['floor_ms'] / row['device_ms']:.1f}% of the "
            f"design's 7-product floor {row['floor_ms']:.6f} ms, "
            f"{100 * row['fma_bound_ms'] / row['device_ms']:.1f}% of "
            f"the f32-FMA bound), plain {row['plain_ms']:.6f} "
            f"({row['plain_device_ms']:.6f}) ms, library (SDPA "
            f"mem-efficient backward, kv repeated) {row['library_ms']:.6f} ms "
            f"per call, {row['library_device_ms']:.6f} ms on the device "
            f"(kernels / library on the device "
            f"{row['device_ms'] / row['library_device_ms']:.3f}; max |kernel "
            f"- library| {row['library_max_abs_diff']:.3e}); "
            f"{row['plan']['blocks']} dkdv and {row['plan']['blocks']} dq "
            f"blocks ({row['plan']['waves']:.2f} waves); against the plain "
            f"backward {row['plain_rel_err']:.3e} of each gradient's largest "
            f"entry (<= {FLASH_BWD_REL[torch.float32]}), lse "
            f"{row['lse_err']:.3e} (<= {FLASH_LSE_TOL}); bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']}, 3xTF32 at 495 "
            f"TFLOP/s), fma_bound {row['fma_bound_ms']:.6f} ms (67 TFLOP/s); "
            f"forward with lse {row['fwd_lse_ms']:.6f} "
            f"({row['fwd_lse_device_ms']:.6f}) ms, without "
            f"{row['fwd_ms']:.6f} ({row['fwd_device_ms']:.6f}) ms | {card}")
        del args, q, k, v, do, lq, lk, lv, lout, got, want, want_lse, lgrad
        del lib, fns, fwd, eq, ek, ev, eout, elog, seed, offset, edo
        torch.cuda.empty_cache()
    # row 5's serving shape: the forward with its logsumexp beside without
    shape = FLASH_TIME_SHAPES[1]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q, k, v = _flash_inputs(shape, torch.float32, gen, True)
    serve_row = {}
    for prefix, lse in (("fwd_lse_", True), ("fwd_", False)):
        fn = lambda: fa.flash_attention(q, k, v, causal=True,  # noqa: E731
                                        return_lse=lse)
        serve_row[prefix + "ms"] = time_ms(lambda _: fn(), [(None,)], iters=5)
        serve_row[prefix + "device_ms"] = device_ms(lambda _: fn(),
                                                    [(None,)], iters=3,
                                                    reps=2)
    rows["serve"] = serve_row
    log(f"time flash forward causal f32 {shape}: with lse "
        f"{serve_row['fwd_lse_ms']:.6f} ({serve_row['fwd_lse_device_ms']:.6f})"
        f" ms, without {serve_row['fwd_ms']:.6f} "
        f"({serve_row['fwd_device_ms']:.6f}) ms | {card}")
    del q, k, v
    torch.cuda.empty_cache()
    return rows


class _KeepGrads:
    """An optimizer that keeps the gradient tree and leaves the params as
    they are: ``make_train_step``'s gradients, read whole."""

    def update(self, params, grads, state):
        self.grads = grads
        return params, state


def flash_train_mono(card: str) -> dict:
    """(b) Full-width smollm-360m cut to 4 layers (2 tower + 2 server) at
    1 x 4096: one ``make_train_step`` on the kernels (flash forward and
    backward) against ``make_train_step(use_kernel=False)`` (the plain
    chunked attention under autograd), every gradient leaf within
    LT_GRAD_REL of its largest plain entry; both peaks."""
    cfg = dataclasses.replace(get_arch("smollm-360m"), num_layers=LT_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = backbone.init_params(cfg, gen, device="cuda")
    batch = {k: to_tensor(v, "cuda") for k, v in next(iter(LMBatchLoader(
        cfg, LT_MONO_BATCH, LT_SEQ, seed=SEED))).items()}
    K, tl = cfg.vertical.num_clients, cfg.vertical.tower_layers
    per_pass = cfg.num_layers - tl + K * tl
    runs = {}
    for use_kernel in (True, False):
        keep = _KeepGrads()
        step = backbone.make_train_step(cfg, keep, use_kernel=use_kernel)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        _, _, loss = step(params, None, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[use_kernel] = (list(_leaves(keep.grads)), float(loss),
                            seconds, torch.cuda.max_memory_allocated(),
                            read_launches())
    launches = runs[True][4]
    expect_launches(launches, {
        "flash_attention_kernel": per_pass, flash_name(64): per_pass,
        **dict.fromkeys(fa.BWD_KERNELS, per_pass)})
    expect_launches(runs[False][4], {})
    worst = 0.0
    for i, (g, p) in enumerate(zip(runs[True][0], runs[False][0])):
        scale = float(p.abs().max())
        err = float((g - p).abs().max()) / scale if scale else \
            float(g.abs().max())
        if not torch.isfinite(g).all() or err > LT_GRAD_REL:
            raise AssertionError(f"mono step leaf {i} {tuple(g.shape)}: "
                                 f"kernel vs plain {err:.3e} of its largest "
                                 f"entry > {LT_GRAD_REL}")
        worst = max(worst, err)
    if abs(runs[True][1] - runs[False][1]) > 1e-4:
        raise AssertionError(f"mono step loss {runs[True][1]} vs plain "
                             f"{runs[False][1]}")
    log(f"flash mono train: {cfg.name} full width cut to {cfg.num_layers} "
        f"layers ({tl} tower x {K} + {cfg.num_layers - tl} server), "
        f"{LT_MONO_BATCH} x {LT_SEQ} tokens, one make_train_step: loss "
        f"{runs[True][1]:.6f} (plain {runs[False][1]:.6f}); "
        f"{len(runs[True][0])} gradient leaves within {worst:.3e} of their "
        f"largest plain entries (<= {LT_GRAD_REL}); {per_pass} flash "
        f"forward and {per_pass} backward launches (each of "
        f"{', '.join(fa.BWD_KERNELS)}); step {runs[True][2]:.4f} s "
        f"(plain {runs[False][2]:.4f} s); max_memory_allocated "
        f"{runs[True][3]} bytes on the kernels, {runs[False][3]} bytes on "
        f"the plain chunked path | {card}")
    del params, batch, runs
    torch.cuda.empty_cache()
    return launches


def flash_train_split(card: str) -> dict:
    """(c) Full-width smollm-360m, ``train_split`` K = 4 avg over threads
    at 2 x 4096, 3 serial steps, step 0 verified against protocol_step at
    1e-5; exact flash launches: a pass (every step once, and step 0's
    verification once more) runs 38 backward (30 server + 4 x 2 tower
    layers) and 46 forward, since a feature holder sends its cut from a
    forward without grad and runs the tower forward again, with grad, in
    its backward (the vjp the JAX worker takes)."""
    cfg = get_arch("smollm-360m")
    K, tl = cfg.vertical.num_clients, cfg.vertical.tower_layers
    per_pass = cfg.num_layers - tl + K * tl
    fwd_per_pass = per_pass + K * tl
    torch.cuda.empty_cache()
    _, metrics, seconds, launches, peak = train(
        cfg, LT_STEPS, "cuda", batch=LT_BATCH, seq=LT_SEQ)
    passes = LT_STEPS + 1
    expect_launches(launches, {
        "merge_reduce_kernel": LT_STEPS, "merge_reduce_bwd_kernel": LT_STEPS,
        "flash_attention_kernel": fwd_per_pass * passes,
        flash_name(64): fwd_per_pass * passes,
        **dict.fromkeys(fa.BWD_KERNELS, per_pass * passes)})
    if metrics.step0_max_dgrad is None or metrics.step0_max_dgrad > 1e-5:
        raise AssertionError(f"step 0 vs protocol_step: "
                             f"{metrics.step0_max_dgrad}")
    tokens = LT_BATCH * LT_SEQ
    steady = metrics.step_times[1:]
    log(f"flash split train: {cfg.name} full width, K = {K} avg over "
        f"threads, {LT_STEPS} steps of {LT_BATCH} x {LT_SEQ} tokens, losses "
        f"{metrics.losses}, step-0 max |dgrad| vs protocol_step "
        f"{metrics.step0_max_dgrad:.3e} (<= 1e-5); "
        f"{len(steady) * tokens / sum(steady):.1f} train tokens/s over "
        f"steps 1-{LT_STEPS - 1} (step times {metrics.step_times} s; step 0 "
        f"includes the verification); flash launches per step "
        f"{fwd_per_pass} forward ({K * tl} of them the towers' forwards "
        f"again under grad), {per_pass} backward (each of "
        f"{', '.join(fa.BWD_KERNELS)}); {fwd_per_pass * passes} and "
        f"{per_pass * passes} in the run with step 0's verification; wall "
        f"{seconds:.4f} s; "
        f"max_memory_allocated {peak} bytes | {card}")
    return launches


def flash_train_phase(card: str) -> dict:
    """Phase 19: (a) the backward kernels against the plain backward, at
    every instantiation and again at the training shapes (batch 2), (b)
    the monolithic step, (c) split training and (d) the launcher, all at
    4096 tokens; returns the launches of (b) and (c) by kernel, and (a)'s
    and the timing's figures."""
    t0 = time.perf_counter()
    checked = check_flash_bwd_kernel()
    rows = time_flash_bwd(card)
    total: dict = {}
    for part in (flash_train_mono(card), flash_train_split(card)):
        for name, n in part.items():
            total[name] = total.get(name, 0) + n
    LAUNCH_DIR.mkdir(parents=True, exist_ok=True)
    launch_cli(card, ("--arch", "smollm-360m"), transport="inproc",
               steps=LT_CLI_STEPS, batch=LT_BATCH, seq=LT_SEQ)
    log(f"flash train: phase 19 took {time.perf_counter() - t0:.1f} s; "
        f"launches {total}")
    return {"launches": total, "checked": checked, "rows": rows}


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
    other = other_phase(card)
    other_total: dict = {}
    for sub in other.values():
        for k, n in sub.items():
            other_total[k] = other_total.get(k, 0) + n
    moe = moe_phase(card)
    modality = modality_phase(card)
    flash_train = flash_train_phase(card)
    flash_launches[64] += flash_train["launches"]["flash_attention_kernel"]

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
                         + overlay_launches.get(name, 0)
                         + other_total.get(name, 0)
                         + moe["deepseek_train"].get(name, 0)
                         + modality["small"].get(name, 0)
                         + modality["whisper_train"].get(name, 0)),
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
        # (phase 11), the ssm training stack (phase 12, and phase 17's moe
        # training at the same shape), the tree's top-level stack (phase
        # 15), the hybrid training stack (phase 16) and whisper's training
        # stack (phase 18), whose launches are in the count
        entry["shapes"] = [
            {"strategy": s, "shape": list(sh), "dtype": "float32",
             "library_ms": None, **rows[(name, s, sh)]}
            for s, sh in MLP_TIME_SHAPES + NOWAIT_TIME_SHAPES
            + SSM_TRAIN_TIME_SHAPES + TREE_TIME_SHAPES
            + HYBRID_TRAIN_TIME_SHAPES + WHISPER_TRAIN_TIME_SHAPES
            if (name, s, sh) in rows]
        for sub in entry["shapes"]:
            if tuple(sub["shape"]) == NOWAIT_SHAPE:
                sub["launches"] = nowait_shape_launches
            if tuple(sub["shape"]) == SSM_TRAIN_SHAPE:
                sub["launches"] = (ssm_train["full"][name]
                                   + moe["deepseek_train"].get(name, 0))
            if tuple(sub["shape"]) == TREE_SHAPE:
                # role 0's launches at the tree's stacks (full width at
                # this shape, reduced width at (2, 2048, 256))
                sub["launches"] = overlay_launches["tree"]
            if tuple(sub["shape"]) == HYBRID_TRAIN_SHAPE:
                sub["launches"] = other["hybrid_train"].get(name, 0)
            if tuple(sub["shape"]) == WHISPER_TRAIN_SHAPE:
                sub["launches"] = modality["whisper_train"].get(name, 0)
        kernels.append(entry)
    def flash_entry(shape, launched=None, dtype=torch.float32):
        """The kernel's row at a timed shape; ``launched`` is its count on
        a main path (a shape timed beside another has none)."""
        f32 = dtype == torch.float32
        row = flash_rows[shape if f32 else (shape, dtype)]
        B, H, Hkv, S, D = shape
        entry = {
            "name": flash_name(D, dtype), "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:27",
            "launches": launched,
            "max_abs_err": flash_worst[D if f32 else (D, "bfloat16")],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "fma_bound_ms": row["fma_bound_ms"],
            "library_ms": row["library_ms"], "device_ms": row["device_ms"],
            "plain_device_ms": row["plain_device_ms"],
            "library_device_ms": row["library_device_ms"],
            "shape": [B, H, S, D], "kv_heads": Hkv, "causal": True,
            "dtype": str(dtype).removeprefix("torch.")}
        if launched is None:
            del entry["launches"]
        return entry

    # the flash kernel by head dim and dtype: 64 on phases 6 and 13, 128
    # (f32) on phase 9's and phase 17's deepseek-moe-16b, 80 on phase 16's
    # stablelm-3b, 112 on its zamba2-7b, 128 in bf16 on its qwen3-32b,
    # phase 17's arctic-480b and phase 18's internvl2-26b (the reduced
    # checks of phase 16 (a) at D 80,
    # 112 and 128 in f32 are not counted); phase 17's timed shapes ride in
    # the D 128 rows, their launches beside them
    row64 = flash_entry((1, 15, 5, 32768, 64), flash_launches[64])
    # phase 19: the forward with its logsumexp (training) beside without
    # it (serving), at this shape and at the training shapes
    row64["forward_with_lse"] = [
        {"shape": list(shape), **{key: flash_train["rows"][
            "serve" if shape == FLASH_TIME_SHAPES[1] else shape][key]
            for key in ("fwd_lse_ms", "fwd_lse_device_ms", "fwd_ms",
                        "fwd_device_ms")}}
        for shape in [FLASH_TIME_SHAPES[1]] + FLASH_TRAIN_SHAPES]
    row64["training_launches"] = \
        flash_train["launches"]["flash_attention_kernel"]
    kernels.append(row64)
    wide = flash_entry((1, 24, 2, 32768, 128), flash_launches[128]
                       + moe["deepseek_forward"][flash_name(128)])
    wide["other_shapes"] = [flash_entry(shape) for shape in FLASH_MOE_F32]
    wide["deepseek_moe_16b_launches"] = \
        moe["deepseek_forward"][flash_name(128)]
    kernels.append(wide)
    kernels.append(flash_entry((1, 32, 32, 8192, 80),
                               other["stablelm"][flash_name(80)]))
    kernels.append(flash_entry((1, 32, 32, 8192, 112),
                               other["hybrid_forward"][flash_name(112)]))
    arctic = moe["arctic_forward"][flash_name(128, torch.bfloat16)]
    internvl = modality["internvl_forward"][flash_name(128, torch.bfloat16)]
    qwen = flash_entry(FLASH_QWEN_SHAPES[0], other["qwen3"][flash_name(
        128, torch.bfloat16)] + arctic + internvl, dtype=torch.bfloat16)
    qwen["other_shapes"] = [flash_entry(shape, dtype=torch.bfloat16)
                            for shape in FLASH_QWEN_SHAPES[1:]
                            + FLASH_MOE_BF16 + FLASH_VLM_BF16]
    qwen["arctic_480b_launches"] = arctic
    qwen["internvl2_26b_launches"] = internvl
    kernels.append(qwen)
    def ssd_entry(shape):
        row = ssd_rows[shape]
        return {
            "name": "ssd_chunk_kernel", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:23",
            "launches": launches["ssd_chunk_kernel"]
            + ssm_train["ssd_chunk_kernel"]
            + launch_launches.get("ssd_chunk_kernel", 0)
            + other["hybrid_forward"]["ssd_chunk_kernel"]
            + other["hybrid_train"]["ssd_chunk_kernel"],
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
            + launch_launches.get("ssd_chunk_bwd_kernel", 0)
            + other["hybrid_train"]["ssd_chunk_bwd_kernel"],
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

    # the server shape of phase 12; the towers' and zamba2-7b's ride in it
    # (their launches are in the count)
    bwd_row = ssd_bwd_entry(SSD_BWD_SHAPES[0])
    bwd_row["other_shapes"] = [ssd_bwd_entry(shape)
                               for shape in SSD_BWD_TIME_SHAPES[1:]]
    for entry in bwd_row["other_shapes"]:
        del entry["launches"]
    kernels.append(bwd_row)

    def flash_bwd_entry(shape):
        row = flash_train["rows"][shape]
        B, H, Hkv, S, D = shape
        checked = flash_train["checked"]
        return {
            "name": "flash_attention_bwd_dkdv_kernel", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            # the gradient of that kernel's function: the JAX package has
            # no backward kernel (jax.grad of its plain chunked attention)
            "replaces": "src/repro/kernels/flash_attention.py:27",
            "launches": flash_train["launches"][fa.BWD_KERNELS[1]],
            "max_abs_err": checked["abs"],
            "max_err_over_largest_entry": checked["rel"][torch.float32],
            "bf16_max_err_over_largest_entry":
                checked["rel"][torch.bfloat16],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "fma_bound_ms": row["fma_bound_ms"],
            "library_ms": row["library_ms"], "device_ms": row["device_ms"],
            "plain_device_ms": row["plain_device_ms"],
            "library_device_ms": row["library_device_ms"],
            "library_max_abs_diff": row["library_max_abs_diff"],
            "kernels_in_call": {
                name: flash_train["launches"][name]
                for name in fa.BWD_KERNELS},
            "note": "one call of flash_attention_bwd launches the four "
                    "kernels in order; ms and device_ms are the four "
                    "together",
            "shape": [B, H, S, D], "kv_heads": Hkv, "causal": True,
            "dtype": "float32"}

    # the server's training shape; the towers' rides in it (its launches
    # are in the count)
    fbwd = flash_bwd_entry(FLASH_TRAIN_SHAPES[0])
    fbwd["other_shapes"] = [flash_bwd_entry(FLASH_TRAIN_SHAPES[1])]
    for entry in fbwd["other_shapes"]:
        del entry["launches"], entry["kernels_in_call"]
    kernels.append(fbwd)
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
