#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) when it fails:

1. build  -- compile the hand-written CUDA kernels (``src/repro_torch/csrc``)
   with nvcc for sm_90a into ``build/`` (skipped when the sources are
   unchanged), print the compiler's register / spill report and each
   library's count of tensor-core instructions (``HGMMA`` = float wgmma,
   ``IGMMA`` = integer wgmma, ``HMMA`` = float mma.sync, ``IMMA`` = integer
   mma.sync) in ``cuobjdump -sass``; the attention library must have HGMMA
   and HMMA, every head_dim 8-32 attention instance HMMA in its own code,
   every instance of the SSD scan's chunk-state and output kernels HMMA in
   its own code, the qmatmul library's wgmma route IGMMA and every instance
   of its streaming route IMMA;
2. kernels -- call each kernel's wrapper on the card at the shapes the
   physics models give it (batch 8192), at LM-like shapes and at the main
   path's own attention shapes (granite-8b's streaming MHA, (1, 32, 1024,
   128) float32 causal; a dense GQA prefill, (1, 32 q / 8 kv, 2048, 128)
   bf16 causal), hold it against its plain PyTorch version on the same
   inputs, and time kernel, plain version and the PyTorch library call that
   computes the same function (a yardstick only; the port never calls it);
   every attention, layernorm, qmatmul and SSD scan case (float32, bf16,
   fp16, int8) also gets its device time from the profiler, kernel and
   library call alike, the SSD scan with each of its three passes' share,
   qmatmul with the route it took (wgmma or streaming); attention
   at head_dim 12 and 80 runs zero-padded to 16 and 128, and head_dim 16
   causal at (1, 8, 1024) beside it; the dense LM path's shapes: granite-8b's
   prefill attend at (8, 32 q / 8 kv, 2048, 128) bf16, minicpm-2b's at
   (1, 36, 2048, 64), starcoder2-7b's window of 4096 over (1, 36 q / 4 kv,
   8192, 128), and their norms at 8 x 2048 rows (RMSNorm at 4096, LayerNorm
   with bias at 4608), bf16; phase 9's: granite-moe-3b-a800m's prefill
   attend at (8, 24 q / 8 kv, 2048, 64) with the LUT softmax in bf16 and in
   float32 (the int8 KV cache's route), SDPA timed beside it as a yardstick
   (it computes the exact softmax), and its RMSNorm at 1536; phase 10's:
   minicpm3-4b's prefill attend at (8, 40, 2048, 96) causal (q/k head_dim
   96, V 64: the kernel's native (96, 64) instance, nothing padded) in
   bf16 with the safe softmax and in float32 with the LUT softmax (the int8
   latent's route), and its q_norm / kv_norm RMSNorms at 768 and 256 over
   8 x 2048 rows, bf16; phase 11's: zamba2-1.2b's shared block attending
   at (8, 32, 2048, 128) causal (bf16 safe and LUT, float32 LUT) and its SSD
   scan at (8, 2048, 64 heads, P 64, N 64, chunk 64) in float32 and bf16,
   hubert-xlarge's (8, 16, 512, 80) both ways and internvl2-1b's (8, 14 q / 2
   kv, 512, 64) causal (bf16, and float32 LUT), rows that see no key (a
   window of 256 ending before kv_len 640, which give the mean of V) on the
   head_dim 16, 64 and 128 routes, and the RMSNorms at 2048, 4096 and 896 and
   the LayerNorm at 1280, bf16;
3. models -- the main path: the paper's three encoders (engine_anomaly,
   btagging, gw) at their published widths, random seeded weights PTQ'd by
   the precision plan, seeded events from ``repro_torch.data``, under the
   ``float`` and ``paper_vu13p`` policies at batch 1 and 8192; logits must
   match the port's CPU path, both kernels' launch counts must grow by the
   expected number per forward, and the median latency (CUDA events) and
   events/s are printed;
4. mha -- the paper's int8 4-stage streaming MHA (``core.streaming_mha``:
   qmatmul, fused attention, qmatmul) at each encoder's published width and
   at granite-8b's, under the ``lut`` and ``safe`` softmax, checked against
   the port's CPU path and the float oracle, with 4 qmatmul and 1 attention
   launches per call; then the LUT softmax entry point
   (``kernels.lut_softmax.lut_softmax``) on the encoders' attention scores;
5. mamba -- mamba2-130m at its published widths (d_model 768, 24 SSM
   heads of P 64, N 128, chunk 64) cut to 12 of its 24 layers (the run's
   time limit; phases 7c and 8d run all 24) on seeded random weights through
   ``models.lm.prefill`` / ``decode_step``: in float32, 2 prompts of 256
   tokens and 64 greedy decode steps held against the port's CPU path
   (logits and tokens) and against one 320-token ``forward`` (continuity),
   with 12 ``ssd_scan`` + 25 ``layernorm`` launches per prefill and 0 + 25
   per decode step; then, in the config's bfloat16, the median time of a
   prefill of 1 x 2048 and 8 x 2048 tokens and of a decode step at batch 1
   and 8, with the profiler's busy share, top kernels and the SSD scan's
   share, and the device operations per decode step with and without
   float32 casts around each norm;
6. dense LM -- the dense GQA family through ``models.lm.prefill`` /
   ``decode_step``: (a) in float32 at the published widths of granite-8b,
   minicpm-2b and starcoder2-7b (and starcoder2-7b with a window of 64, so
   the rolling buffer wraps) cut to 2 layers and a vocab of 512, 2 prompts
   of 128 tokens and 16 greedy steps held against the port's CPU path
   (logits and tokens) and one 144-token ``forward`` (continuity), with 2
   ``flash_attention`` + 5 ``layernorm`` launches per prefill and 0 + 5 per
   decode step; (b) granite-8b in bfloat16 at its published widths (d_model
   4096, 32 q / 8 kv heads of 128, d_ff 14336, vocab 49152) cut to 5 of
   its 36 layers (the run's time limit; phases 7 and 9 serve it at 5 too) on
   seeded random weights drawn on the card: the median time of a
   prefill of 1 x 2048 (time to first token) and 8 x 2048 tokens and of 32
   greedy decode steps at batch 1 and 8, with the profiler's busy share,
   top kernels, attention and layernorm shares, the device operations per
   decode step and the cache bytes each step copies.
7. serve -- the serving engine (``serve.api.Engine``: scheduler, cache
   manager, executor) on the card: (a) in float32, granite-8b (dense, and
   paged + prefix cache) and mamba2-130m at their published widths cut to 2
   layers and a vocab of 512, 6 requests x 8 greedy tokens: the card
   engine's streams, the port's CPU engine's and a direct ``lm.prefill`` /
   ``decode_step`` loop on the card each equal the CPU direct loop, a step
   differing only where its top-two margin is under 2e-4; (b) granite-8b in
   bfloat16 at its published widths and 5 of its 36 layers (the run's time
   limit), ``max_batch`` 8, ``max_seq_len`` 2048, buckets
   256-2048, 4 decode steps per dispatch, 16 seeded requests of 64-1536
   tokens (8 sharing a 512-token prefix) x 32 new tokens under the dense,
   paged and paged + prefix-cache layouts: identical tokens across the
   three, ``flash_attention`` once per layer per prefill dispatch and never
   in decode, ``layernorm`` 2 per layer + 1 per prefill dispatch and decode
   step, the program budget ``len(buckets) + 2``; TTFT p50/p95 and ITL p50
   from ``TokenEvent.ts``, output tokens/s, peak memory, and over one pure
   decode dispatch the profiler's device-busy share, the device operations
   per decode step and the paged gather's share of decode device time;
   (c) mamba2-130m in bfloat16 at full depth, 8 requests, ``ssd_scan`` once
   per layer per prefill dispatch;
8. train -- (a) the gradients of ``mha`` and ``layernorm`` on the card, which
   go through their ``torch.autograd.Function`` (kernel forward, torch-op
   backward), against torch autograd through the plain versions: attention
   ``safe`` and ``lut`` at the encoders' shapes (batch 1024), granite-like
   GQA (2, 32/8, 256, 128) causal in float32 and bf16, a window with
   kv_len < L; LN, RMSNorm and the LUT norm at the encoders' and granite's
   widths; ``SSDScan`` (the ``ssd_scan`` kernel forward, the plain scan's
   gradient) at mamba2-130m's and zamba2-1.2b's widths in float32 and bf16;
   ``lut_softmax`` and ``qmatmul`` must raise under grad; (b) the paper's
   physics workflow (``repro_torch.examples.physics_inference``) for the
   three encoders at batch 1024: the first
   float steps on the card against the port's CPU path from the same init,
   the launches per train step (``flash_attention`` n_layers, ``layernorm``
   2 n_layers + 1 or 0), the step time, then 150 float steps, PTQ and 60
   QAT steps under the paper-optimal policies and ``paper_vu13p``, whose
   float AUC and AUC ratios must be within 0.02 of the JAX package's run of
   ``examples/physics_inference.py``; (c) ``train.run_training`` on
   granite-8b's published width cut to 1 layer, float32, 2 x 2048 tokens,
   8 steps with a checkpoint at step 4, then again killed at step 6 and
   resumed (under ``torch.use_deterministic_algorithms(True)``): the two
   runs' parameters and moments bitwise equal, the card's checkpoint
   restored on the CPU bitwise equal; the step's time, tokens/s, device
   busy share, top kernels, the attention and layernorm backwards' shares
   and the peak memory; (d) ``run_training`` on mamba2-130m (24 layers) and
   zamba2-1.2b (7 of 38 layers) at full width, float32, 2 x 2048 tokens:
   ``ssd_scan`` once per Mamba2 layer and ``flash_attention`` once per
   shared application per step, each step's loss within 1e-4 of the CPU
   path's from the card's state, mamba2-130m killed and resumed bitwise;
   step time, peak memory, busy share; (e) ``make_train_step(mesh=,
   rules=)`` on a one-card NCCL mesh, bitwise the unsharded step, and the
   sharded checkpoint restored onto the rules' shardings bitwise (b-e
   under deterministic algorithms).  ``python3 tools/phase.py train`` runs
   this phase alone.
9. int8_moe -- the ``int8_serve`` datapath (int8 per-channel weights, the
   int8 KV cache in the dense, rolling and paged layouts, the LUT softmax in
   the engine's prefill, which attends the dequantized cache through the
   attention kernel's float32 route) and the MoE family: (a) in float32
   under int8_serve, granite-8b and granite-moe-3b-a800m at their published
   widths cut to 2 layers and a vocab of 512 and dbrx-132b cut to 1 layer,
   through the engine (dense, paged) and a direct ``lm`` loop on the card
   and the port's CPU engine, held to the CPU direct loop by phase 7's
   margin rule (the MoE models at a capacity factor that drops nothing);
   one prefill at the published capacity factor on the card and the CPU:
   the share of int8 KV codes that differ (by at most 1), of router
   decisions that flip (only at a k-th / (k+1)-th tie within 1e-5), and the
   dropped shares; (b) granite-moe-3b-a800m bf16 at 4 of its 32 layers (the
   run's time limit) under its
   ``serve_policy`` (int8_serve), phase 7's traffic under the dense, paged
   and paged + prefix-cache layouts, tokens identical but where a request
   reads a prefix-cache hit (at the published capacity factor an expert's
   drops make a prompt's KV depend on the tokens batched with it), and
   identical on every request at a capacity factor of e / k: tokens/s, TTFT,
   ITL, decode device ms per step beside its weights' bytes floor, the
   routing / dispatch / combine and expert-GEMM shares, KV bytes, peak
   memory, the program budget; (c) its ``lm.prefill`` at 1 and 8 x 2048
   under int8_serve and float, beside the counted roofline floor (phase
   12's count); (d) granite-8b bf16 at
   5 layers under int8_serve, dense and paged, beside phase 7's float runs
   of the same build.  ``python3 tools/phase.py int8_moe`` runs this phase
   alone.
10. mla -- multi-head latent attention, minicpm3-4b (``attention.mla_apply``
   and the packed latent caches): (a) in float32 at its published widths cut
   to 2 layers and a vocab of 512, under ``float`` and under its
   ``serve_policy`` (int8_serve: int8 weights, the int8 latent with a
   float32 scale per token, the LUT softmax in prefill), the card's engines
   (dense, paged), direct ``lm`` loops on the card with the materialized and
   the absorbed decode and the port's CPU engine, held to the CPU direct
   loop by phase 7's margin rule; the absorbed decode's logits within 2e-4
   of the materialized ones on the card; under int8_serve one prefill's
   int8 latent codes card vs CPU differ by at most 1 in at most 0.1 % of
   them; (b) bf16 at 12 of its 62 layers (the run's time limit) under
   int8_serve, phase 7's traffic under
   the dense, paged and paged + prefix-cache layouts with identical tokens,
   ``flash_attention`` n_layers per prefill dispatch and none in decode,
   ``layernorm`` 4 n_layers + 1 per prefill dispatch and decode step: TTFT,
   ITL, tokens/s, decode device ms per step beside the materialized decode's
   float32 floor, device operations per step, busy share, latent cache
   bytes beside float32 latents and a float32 GQA cache of the same heads,
   peak memory; then the dense layout with the absorbed decode (its ITL,
   device ms per step, and the share of its tokens equal to the
   materialized run's); (c) ``lm.prefill`` at 1 and 8 x 2048 under
   int8_serve and float, beside its counted roofline floor, with the
   attention kernel's share.  ``python3 tools/phase.py mla`` runs this phase alone.
11. families -- the hybrid family (zamba2-1.2b: Mamba2 blocks and the
   weight-shared attention block over concat(x, x_embed)) and the modality
   frontends (hubert-xlarge's frame embeddings, internvl2-1b's patch
   embeddings, both the reference's stubs): (a) in float32 at the published
   widths, zamba2-1.2b cut to 7 layers (two applications of the shared
   block) and a vocab of 512 through the card's engines (dense, and paged,
   which falls back to dense with identical tokens), a direct ``lm`` loop on
   the card and the port's CPU engine, held to the CPU direct loop by phase
   7's margin rule; hubert-xlarge cut to 2 layers, its logits on the card
   within 2e-4 of the CPU's; internvl2-1b cut to 2 layers, 256 patches and
   64 tokens then 16 greedy steps against the CPU path and one forward;
   (b) zamba2-1.2b bf16 at 13 of its 38 layers (the run's time limit) under
   int8_serve and float, 16
   exact-length requests of 64-512 tokens x 32 new tokens, dense and paged:
   identical tokens, ``ssd_scan`` once per layer and ``flash_attention``
   once per shared application per prefill dispatch and neither in decode,
   the programs (one per prompt length, one decode), TTFT, ITL, tokens/s,
   one decode dispatch profiled, the Mamba2 state's and the 3 shared K/V
   caches' bytes; (c) hubert-xlarge (16 of 48 layers) ``lm.forward`` on 1 and 8 x
   512 frames with its pad copies' share of device time (head_dim 80 runs
   padded to 128), internvl2-1b (8 of 24 layers) ``lm.prefill`` of 1 and 8 x
   (256 + 256) tokens and 32 greedy decode steps, bf16, under float and
   int8_serve.  ``python3 tools/phase.py families`` runs this phase alone.
12. roofline -- the package's counts (``repro_torch.roofline``) against the
   card, after every other phase and with no timing of its own: (a) each of
   the physics encoders at batch 8192 (both policies, phase 3), granite-8b's
   ``lm.prefill`` of 8 x 2048 at 5 layers (phase 6), mamba2-130m's at 12
   layers (phase 5), granite-moe-3b-a800m's and minicpm3-4b's at 4 and 12
   layers under int8_serve and float (9c, 10c), hubert-xlarge's forward of
   8 x 512 frames and internvl2-1b's prefill of 8 x 512 tokens under float
   and int8_serve (11c) is counted once on the card under
   ``op_counter.OpCounter`` (its kernel launches priced by
   ``roofline.kernel_costs``) and once on meta tensors (the plain versions'
   volume re-priced by ``roofline.analysis.fused_work``): the two FLOP
   counts must agree to 1e-6; (b) the fused H100 bound of each call may not
   exceed the device time its phase measured by more than 5 %, and a
   ``[roofline]`` line prints its FLOPs by type, bytes, dominant term,
   bound, device ms, the bound's share and the model FLOPs' share of the
   bf16 peak beside the card's name and power limit; (c) granite-8b at 5
   layers on the dry run's ``card`` mesh: the argument bytes of its prefill
   equal the bytes of the parameters, caches and tokens allocated on the
   card; (d) the paper's FPGA cycle model of each encoder at R 1, 2, 4
   beside phase 3's batch-1 latency (a print).  ``python3 tools/phase.py
   roofline`` runs this phase alone (no device times: (b) is skipped).
13. engine -- the rest of the serving engine, granite-8b bf16 at its
   published widths and 5 of its 36 layers, phase 7b's 16 requests x 32 new
   tokens (max_batch 8, 4 decode steps per dispatch); streams compared
   below may part only at a step whose top-two margin in the card's direct
   greedy loop is under phase 7's 2e-4: (a) the async loop against the sync
   loop, dense and paged + prefix cache, with phase 7's launch and program
   checks: identical streams, TTFT p50/p95, ITL p50 and tokens/s side by
   side; traced in overlap mode no fence, ``overlap_efficiency`` and
   ``host_bubble_s``; every steady-state pure decode dispatch under
   ``torch.cuda.set_sync_debug_mode("error")`` raises nothing; one async
   decode step profiled (busy share); (b) ``submit(n=4)`` greedy and
   seeded-sampled: no fork on the card (the kernel prefill is not
   replayable), greedy siblings equal the n=1 stream, two seeded runs
   identical; (c) the victim tier, paged + prefix cache over 512 device
   pages and 1024 host pages, the shared-prefix prompts submitted again:
   spills and swap-ins, every swapped-in page's rows bitwise the rows it
   spilled, the streams of the run without the tier, the bytes moved and
   victim-tier flushes' seconds (GB/s); (d) the router with 2 replicas on the
   card: one engine's streams, 8 admitted per replica, the allocation two KV
   pools and no second copy of the weights; (e) ``shard_decode`` in a
   one-card NCCL group: params and pools DTensors, one engine's streams,
   one decode shape; (g) ``shard_decode`` over two processes on the card
   (gloo: NCCL refuses two ranks on one device), spawned together: rank 0's
   ``Engine`` sends every device program, rank 1 runs them in
   ``serve_worker``, 4 of the 8 slots each, the prefill replicated; phase
   7's first 8 prompts (the shared prefix; cut for the run's time) with
   phase 7's launch and program checks on rank 0, one
   decode shape (4, 4 steps) per rank, tokens/s beside the card's name and
   power limit: bf16 at 5 layers, dense and paged + prefix cache, rank 0's
   streams bitwise the one-rank engine's at 4 slots (a rank's decode
   shape: cuBLAS rounds a bf16 decode at 4 rows otherwise than at 8, so
   against the 8-slot engine the partings and their direct-loop margins
   are recorded), and float32 at 2 layers, dense, bitwise the 8-slot
   one-rank engine's; (f) the reference's Pallas row: chunking,
   prefix-skip, preemption and speculative decoding asked for on the card
   are each named in ``disabled_features`` with a RuntimeWarning and the
   engine serves; the same ServeConfig on the port's CPU engine disables
   nothing and runs extend dispatches and drafts.  ``python3 tools/phase.py
   engine`` runs this phase alone.
   Each path sets the launch counts to 0 before it and reads them after.
14. tp -- the step split over the model axis (``distributed.tensor_parallel``,
   ``make_train_step(mesh=, rules=)`` with ``split == "model"``): first phase
   2's cases at the split's local shapes (granite-8b's attend at model 2,
   (2, 16 q / 4 kv, 2048, 128) causal, float32 and bf16, forward and
   backward; its RMSNorm over (4096, 4096), forward and backward;
   minicpm3-4b's attend at model 2, (8, 20, 2048, 96 / V 64) causal bf16,
   SDPA beside it; zamba2-1.2b's scan at model 2, (2, 2048, 32 heads, 64,
   N 64) float32, forward and backward; hubert-xlarge's attend at model 2,
   (8, 8, 512, 80) both ways bf16, padded to the 128 instance, and
   internvl2-1b's, (8, 7 q / 1 kv, 2048, 64) causal bf16, SDPA beside
   them), then two processes on the one
   card, a (data 1, model 2) mesh over gloo (NCCL refuses two ranks on one
   device), spawned together (one failed rank fails the run): (a)
   granite-8b at its published widths, 2 layers, float32, 2 x 2048 tokens,
   2 split steps, each from the state the unsharded step on the whole batch
   on the card starts from, the loss within 1e-4, every moment of the
   rank's shard within 1e-4 of its leaf's largest magnitude (float32
   rounding reaches 1.1e-5 there) and every parameter within 1e-5 of
   max(1, |x|) (or, at most 1e-4 of them, where Adam's m / sqrt(v)
   amplifies a gradient at the rounding's size, off by exactly what the
   two runs' moments give through AdamW); (b) granite-moe-3b-a800m the
   same (20 of its 40 experts per rank), ``moe_dropped_frac`` equal to the
   unsharded value exactly; (d) minicpm3-4b (MLA: 20 of 40 heads per rank,
   the latents whole) and (e) zamba2-1.2b (32 of 64 SSM heads, 16 of 32
   shared-block heads; layer 0 applies the shared block) the same; (g)
   granite-moe-3b-a800m on a (data 2, model 1) mesh, each rank one row of
   the batch (the ``"repeat"`` pattern), against the whole-batch step, its
   capacity, drops and aux loss the whole batch's: the dropped share
   exact; (h) hubert-xlarge (frames and labels, 8 of 16 heads of 80,
   bidirectional) and internvl2-1b (256 patches before 1792 tokens, 7 of 14
   q heads over 1 of 2 kv heads) as (a); (c) granite-8b and (f)
   minicpm3-4b in bf16, 2 layers, a prefill of 1 x 2048 and 8 greedy
   decode steps over the rank's caches (4 kv heads; the whole latent), (i)
   internvl2-1b the same after 256 patches and 256 tokens (1 kv head), (j)
   granite-8b under ``int8_serve`` (its weights the plan's transform of
   the whole leaves, cut after it; the int8 KV cache narrowed by kv head;
   the LUT softmax), both runs fed the unsharded run's tokens: a greedy
   token may differ only where the unsharded top-two margin is under 5e-2
   (bf16).  Per rank: the state's GB and the step's peak above it,
   split and unsharded, step ms (the two ranks share the card: these times
   say nothing of TP speed) and the collectives' bytes.  Each split call (a
   train step, a prefill, each decode step) runs in a window of its own:
   the counts set to 0 just before it and read just after, the unsharded
   runs outside; each must launch ``layernorm`` once per norm (2 per GQA
   block, 4 per MLA block, 2 per Mamba2 block and per shared-block
   application, and the final norm), ``flash_attention`` once per
   attention (none in decode) and ``ssd_scan`` once per Mamba2 layer (none
   in decode), the attention and the scan at the rank's heads.  The
   kernels line sums the windows of both ranks.  ``python3 tools/phase.py
   tp`` runs this phase alone.

Then a JSON line listing the kernels, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.  The full measurements
go to ``chiprun_out/chip_smoke.json``.  Without a CUDA device, or without
the repository around this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

# The card's published peaks and the kernels' work are the package's:
# repro_torch.core.latency_model.H100 and repro_torch.roofline.kernel_costs.

MODELS = ("engine_anomaly", "btagging", "gw")
POLICIES = ("float", "paper_vu13p")
BATCHES = (1, 8192)
SEED = 0

# Tolerances of the kernel-vs-plain checks (the CPU parity tests' values).
# safe / exact: float32 sums in another order.  lut: that order can also move
# a nearest-table entry at a bin boundary, by one entry.  An exp-table flip
# scales one key's weight by 1.6 %, moving the output by at most 1.6 % of
# |v_j - out| <= 1.6 % (|out| + max|v|); a 1/x flip scales the row by 0.8 %;
# a 1/sqrt flip scales dm * inv * gamma by 0.3 %.  Rows with a flip are held
# to that bound and must be under 1 % of the rows (a row of L keys has L
# chances of a flip: 0.005 % of the rows at the physics shapes, 0.11 % at
# L = 1024 were seen over atol on an H100).
FLIP_ROWS = 1e-2
ATT_ATOL = {"safe": 2e-5, "lut": 1e-4}
ATT_LUT_STEP = 0.016
BF16_ATOL, BF16_RTOL = 1e-2, 8e-3  # one bf16 rounding (2^-7 relative at most)
LN_ATOL = 1e-5
LN_LUT_STEP = 0.003

# Logits on the card vs the port's CPU path.  float: cuBLAS and the CPU sum
# the projections in other orders (logits up to ~10).  paper_vu13p: the
# products of ap_fixed<12,6> operands are exact, but the two paths' scores
# differ by an ulp, which flips an exp-table entry in about 1 of 1e5 scores;
# the slightly moved attention output then crosses a 2^-6 activation level in
# about 1 % of the events (0.68 % of engine_anomaly's at batch 8192 on an
# H100), moving that event's logits by ~1e-2.  So at most 2 % of the events
# may exceed 1e-3, and none may exceed 0.1.
MODEL_TOL = {"float": 1e-4, "paper_vu13p": 1e-3}
MODEL_FLIP_EVENTS, MODEL_FLIP_CAP = 2e-2, 1e-1
CPU_CHECK_EVENTS = 1024

# qmatmul: exact int32 sums and the same float epilogue -> bitwise.
# lut_softmax: the exp entries are the same (same index arithmetic on the
# same score), the row sums are taken in another order, so a row at a
# 1/x-table tie may take the neighbouring entry, 0.76 % away (then cross one
# ap_fixed level); such rows must be under FLIP_ROWS.
SOFTMAX_INV_STEP = 0.008
# Streaming MHA on the card vs the port's CPU path, stage by stage: stage 1
# (per-row codes, exact int32 sums, the same epilogue) and stage 4 on the
# same attention output are bitwise equal; the attention in between sums in
# another float order and may flip a LUT entry at a tie (its own tolerance,
# phase 2), which can flip a stage-4 int8 code at a rounding tie.  One flip
# moves a token's output by about 3 / (127 sqrt(d)) of its norm (d = 16 ..
# 4096: 0.6 % .. 0.04 %), so end to end the relative Frobenius error must
# stay under 1e-2.  Against the float oracle: the JAX test's bound, < 0.1.
MHA_TOL, MHA_REL_VS_CPU, MHA_FLOAT_REL = 1e-4, 1e-2, 0.1
# (d_model, n_heads, seq, causal) of granite-8b's attention, run as MHA
# (streaming_mha has no GQA) at batch 1.
GRANITE = (4096, 32, 1024, True)
# SSD scan vs its plain version: float32 sums in another order, the JAX
# kernel test's 1e-4 on y and on the final state.
SSD_ATOL = 1e-4
# the SSD scan's three device kernels (csrc/ssd_scan.cu), by function name
SSD_PASSES = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_output_kernel")
# mamba2-130m, float32: logits on the card vs the port's CPU path, and the
# decoded logits vs one forward over the whole sequence, within
# tests/test_ssm.py's 2e-4 (float32 sums in other orders).  A greedy token
# may differ only where the CPU path's top-two margin is below that bound.
MAMBA = "mamba2-130m"
MAMBA_LAYERS = 12  # of 24, for the run's time limit (phases 7c and 8d run all 24)
MAMBA_TOL = 2e-4
MAMBA_CHECK = (2, 256, 64)  # batch, prompt tokens, greedy decode steps
MAMBA_TIME_LEN, MAMBA_TIME_BATCHES, MAMBA_TIME_STEPS = 2048, (1, 8), 32
# The dense GQA family, float32 check (phase 6a): the published widths cut to
# 2 layers and a vocab of 512, the same 2e-4 and margin rule as mamba2-130m;
# starcoder2-7b runs twice, the second time with a window of 64 so that its
# rolling buffer (and the kernel's window mask) is exercised by 128 + 16
# tokens.  bf16 timings (phase 6b): granite-8b at its published widths, 18
# of its 36 layers (GRANITE_TIME_LAYERS, the script's time limit).
DENSE = ("granite-8b", "minicpm-2b", "starcoder2-7b")
DENSE_CUT = dict(n_layers=2, vocab_size=512, dtype="float32")
DENSE_ROLLING_WINDOW = 64
DENSE_TOL = 2e-4
DENSE_CHECK = (2, 128, 16)  # batch, prompt tokens, greedy decode steps
GRANITE_TIME_LEN, GRANITE_TIME_BATCHES, GRANITE_TIME_STEPS = 2048, (1, 8), 32
GRANITE_TIME_LAYERS = 5  # of 36, for the run's time limit
GRANITE_PROFILE_STEPS = 16  # the decode steps under the profiler
# The serving engine (phase 7).  (a) float32 check: granite-8b (dense, and
# paged + prefix cache) and mamba2-130m at their published widths cut as in
# phase 6a, 6 requests (the first 3 sharing a 32-token prefix; lengths <= 64
# or multiples of 64, mamba2's chunk) x 8 greedy tokens, held to the same
# 2e-4 margin rule against the CPU direct loop.  (b) granite-8b bf16 at its
# published widths, GRANITE_SERVE_LAYERS of its layers: 16 requests of
# 64-1536 tokens from a seed, 8 sharing a 512-token prefix, 32 new tokens
# each, under three layouts that must give identical tokens.  (c)
# mamba2-130m bf16 at full depth, 8 requests.
SERVE_CHECK = (("granite-8b", ({}, dict(kv_layout="paged", kv_page_size=16,
                                         kv_prefix_cache=True)), (40, 50, 64, 12, 20, 33)),
               ("mamba2-130m", ({},), (40, 48, 64, 12, 20, 33)))
SERVE_CHECK_SC = dict(max_batch=4, max_seq_len=128, prefill_buckets=(32, 64), decode_steps=4)
SERVE_CHECK_NEW = 8
SERVE_SC = dict(max_batch=8, max_seq_len=2048, prefill_buckets=(256, 512, 1024, 2048),
                decode_steps=4)
SERVE_LAYOUTS = ({}, dict(kv_layout="paged", kv_page_size=16),
                 dict(kv_layout="paged", kv_page_size=16, kv_prefix_cache=True))
SERVE_REQUESTS, SERVE_LEN, SERVE_NEW = 16, (64, 1536), 32
SERVE_SHARED, SERVE_SHARED_REQUESTS = 512, 8
MAMBA_SERVE_SC = dict(max_batch=8, max_seq_len=1024, decode_steps=4)
MAMBA_SERVE_LEN = (64, 128, 192, 256, 320, 384, 448, 512)  # exact-length: multiples of the chunk
# int8_serve and the MoE family (phase 9).  (a) float32 check under
# int8_serve (int8 per-channel weights, the int8 KV cache, the LUT softmax in
# prefill): granite-8b and granite-moe-3b-a800m at their published widths cut
# to 2 layers and a vocab of 512, dbrx-132b cut to 1 layer (3.3 B parameters,
# 13 GB in float32, and a copy on the host for the CPU engine), through the
# Engine (dense, paged) and a direct lm loop on the card, all held to the
# port's CPU direct loop by phase 7's margin rule (the MoE models there at a
# capacity factor of n_experts / top_k, so that nothing is dropped and a
# token's output does not depend on the tokens batched with it: the direct
# loop runs one request at batch 1, the engine 4 slots of a padded bucket);
# one prefill at the published capacity factor: its int8 KV codes
# on the card and the CPU may differ by 1 (a k/v value a float32 ulp from a
# rounding tie), and a router decision may flip only where the CPU's k-th and
# (k+1)-th probabilities lie within 1e-5.  (b) granite-moe-3b-a800m bf16 at
# MOE_SERVE_LAYERS of its 32 layers under its serve_policy (int8_serve), phase
# 7's traffic and layouts; (c) its lm.prefill at 1 and 8 x 2048; (d)
# granite-8b bf16 at GRANITE_SERVE_LAYERS under int8_serve, dense and paged,
# beside phase 7's float runs.
INT8_CHECK = (("granite-8b", 2, (40, 50, 64, 12, 20, 33), SERVE_CHECK_NEW),
              ("granite-moe-3b-a800m", 2, (40, 50, 64, 12, 20, 33), SERVE_CHECK_NEW),
              ("dbrx-132b", 1, (40, 64, 12, 33), 4))
INT8_LAYOUTS = ({}, dict(kv_layout="paged", kv_page_size=16))
INT8_CODES = (2, 64)  # batch, tokens of the prefill whose codes and routes are compared
ROUTER_TIE = 1e-5
MOE_SERVE = "granite-moe-3b-a800m"
MOE_PREFILL_BATCHES, MOE_PREFILL_LEN = (1, 8), 2048
# The full-width serving runs of phases 7b, 9b-9d, 10b-10c and 11b-11c cut in
# depth for the run's time limit: granite-8b 5 of 36 layers,
# granite-moe-3b-a800m 4 of 32, minicpm3-4b 12 of 62, zamba2-1.2b 13 of 38
# (the shared block 3 times), hubert-xlarge 16 of 48, internvl2-1b 8 of 24.
GRANITE_SERVE_LAYERS, MOE_SERVE_LAYERS, MLA_SERVE_LAYERS = 5, 4, 12
HYBRID_SERVE_LAYERS, FRONTEND_TIME_LAYERS = 13, {"hubert-xlarge": 16, "internvl2-1b": 8}
# MLA, minicpm3-4b (phase 10).  (a) float32 check at the published widths cut
# to 2 layers and a vocab of 512, under float and under its serve_policy
# (int8_serve: int8 weights, the int8 latent cache, the LUT softmax in
# prefill): the card's engines (dense, paged) and direct lm loops with the
# materialized and the absorbed decode, and the port's CPU engine, held to
# the CPU direct loop by phase 7's margin rule; under int8_serve one
# prefill's int8 latent codes card vs CPU differ by at most 1 in at most
# 0.1 % of the codes; the absorbed decode's logits within 2e-4 of the
# materialized ones on the card (tests/test_models_smoke.py's bound).  (b)
# bf16 at MLA_SERVE_LAYERS of its 62 layers under int8_serve, phase 7's
# traffic and layouts, then
# the dense layout again with the absorbed decode; (c) lm.prefill at 1 and 8
# x 2048 under int8_serve and float.
MLA = "minicpm3-4b"
MLA_CHECK_LENGTHS = (40, 50, 64, 12, 20, 33)
MLA_CODES_SHARE = 1e-3
MLA_ABSORB_TOL = 2e-4
MLA_ATTENTION = (8, 40, 2048, 96)  # the prefill attend: batch, heads, tokens, q/k head_dim
MLA_PREFILL_BATCHES, MLA_PREFILL_LEN = (1, 8), 2048
# The hybrid family and the modality frontends (phase 11).  (a) float32
# checks at the published widths: zamba2-1.2b cut to 7 layers (the shared
# block at layers 0 and 6) and a vocab of 512 through the engine, held to the
# CPU direct loop by phase 7's margin rule, prompts of at most its chunk
# (64); hubert-xlarge cut to 2 layers, 2 x 256 frames, logits card vs CPU
# within 2e-4 (tests/test_ssm.py's and phase 6's bound); internvl2-1b cut to
# 2 layers and a vocab of 512, 2 x (256 patches + 64 tokens) and 16 greedy
# steps, the margin rule.  (b) zamba2-1.2b bf16 at HYBRID_SERVE_LAYERS, phase 7c's
# exact-length traffic twice over (16 requests of 64-512 tokens) x 32 new
# tokens, under int8_serve and float, dense and paged (which falls back to
# dense).  (c) hubert-xlarge (FRONTEND_TIME_LAYERS) on 1 and 8 x 512 frames (10 s of
# audio at 50 frames/s) and internvl2-1b (likewise) on 1 and 8 x (256 image
# + 256 text) tokens then 32 greedy decode steps, bf16, under float and
# int8_serve.  Weights random from the seed; the frontends' frame and patch
# embeddings random too (the reference's stubs).
HYBRID, AUDIO, VLM = "zamba2-1.2b", "hubert-xlarge", "internvl2-1b"
HYBRID_CHECK_LAYERS, FRONTEND_CHECK_LAYERS = 7, 2
HYBRID_CHECK_LENGTHS = (40, 48, 64, 12, 20, 33)  # exact-length prefill: <= the chunk
AUDIO_CHECK, AUDIO_TOL = (2, 256), 2e-4  # batch, frames
VLM_CHECK = (2, 64, 16)  # batch, text tokens after the patches, greedy steps
HYBRID_SERVE_SC = MAMBA_SERVE_SC
HYBRID_SERVE_LEN = MAMBA_SERVE_LEN * 2
HYBRID_LAYOUTS = ({}, dict(kv_layout="paged", kv_page_size=16))
FRONTEND_BATCHES, AUDIO_FRAMES, VLM_TEXT, VLM_DECODE_STEPS = (1, 8), 512, 256, 32
FAMILY_ATTENTION_ROWS = (8, 2048)  # zamba2's shared block and scan in phase 2: batch, tokens
# kernel names in the profiler, for each kernel's share of device time
KERNEL_FUNCS = {"attention": ("small_attention_kernel", "tc_attention_kernel"),
                "layernorm": ("layernorm_kernel",),
                "qmatmul": ("qmatmul_wgmma_kernel", "qmatmul_stream_kernel"),
                # the paged decode view's index_select (phase 7; the embedding
                # lookup's row gather shares the kernel, a few KB per step)
                "gather": ("vectorized_gather_kernel",)}


class SmokeError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median_ms(fn, iters: int, warmup: int = 5) -> float:
    """Median of per-call times, each call bracketed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_times(fn, iters: int = 20) -> dict[str, float] | None:
    """Device ms per call of ``fn`` by kernel name under ``torch.profiler``,
    free of the host's launch cost; None when no trace shows every call's
    device time.  A trace now and then comes back empty, or with some of
    its kernel records lost (a kernel counted fewer times than the calls
    launch it, so its time per call reads low): it is taken again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, us, e.count) for e in prof.key_averages()
                if (us := getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0)) > 0]
        if rows and all(count % iters == 0 for _, _, count in rows):
            return {key: us / iters / 1e3 for key, us, _ in rows}
    return None


def device_ms(fn, iters: int = 20) -> float | None:
    """Device time per call of ``fn``: the sum of its kernels' times."""
    times = device_times(fn, iters)
    return None if times is None else sum(times.values())


def _kernel_label(key: str) -> str:
    """A kernel's name cut to 48 characters; a PyTorch elementwise kernel is
    named by the operation it was instantiated for (its functor or the
    ``*_kernel_cuda`` that launched it), which its name holds only far past
    that cut."""
    label = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    if "elementwise_kernel" in label:
        ops = [m for m in re.findall(r"\w*(?:Functor\w*|_kernel_cuda|_kernel_impl)\b", label)
               if m not in ("BinaryFunctor", "AUnaryFunctor", "BUnaryFunctor")]
        if ops:
            return f"elementwise {ops[0]}"[:48]
    return label[:48]


def profile_forward(fn, iters: int = 5) -> dict:
    """Device-busy share, the top kernels by device time and the device
    operations (kernels, copies, fills) per call over ``iters`` calls under
    ``torch.profiler``, tracing the device only: recording the host's
    operations as well slows the traced calls and the reading of the trace.
    The profiler's own host cost is in the wall time, so the busy share is a
    lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a trace now and then comes back empty: one more try
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows, ops = [], 0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ops += e.count
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((dev_us, e.key))
        busy_us = sum(us for us, _ in rows)
        if busy_us > 0:
            break
    else:
        return {"busy_share": None, "top": "not measured (no device time in the trace)"}
    rows.sort(reverse=True)
    top = [(_kernel_label(k), round(us / busy_us, 3)) for us, k in rows[:6]]
    ssd_us = sum(us for us, k in rows if any(name in k for name in SSD_PASSES))
    shares = {f"{kname}_share": sum(us for us, k in rows if any(f in k for f in funcs)) / busy_us
              for kname, funcs in KERNEL_FUNCS.items()}
    return {"busy_share": busy_us / wall_us, "device_ms_per_fwd": busy_us / iters / 1e3,
            "device_ops_per_fwd": ops / iters, "top": top, "ssd_scan_share": ssd_us / busy_us,
            **shares}


def pad_ops(fn) -> dict[str, int]:
    """The zero-pad operators (``aten::constant_pad_nd``, ``aten::pad``) one
    call of ``fn`` runs, by name, from a trace of the host's operators."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.key in ("aten::constant_pad_nd", "aten::pad")}


def close_enough(out, ref, atol, rtol=0.0, flip_allow=None) -> tuple[float, float, bool]:
    """(max abs error, share of rows over atol/rtol, within tolerance).
    ``flip_allow``: the extra error a one-entry LUT flip may cause, allowed
    on at most ``FLIP_ROWS`` of the rows."""
    err = (out.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    rows_over = float((err > limit).reshape(-1, err.shape[-1]).any(dim=-1).float().mean())
    ok = rows_over == 0.0
    if not ok and flip_allow is not None:
        ok = bool((err <= limit + flip_allow).all()) and rows_over <= FLIP_ROWS
    return float(err.max()), rows_over, ok


# ---------------------------------------------------------------- phase 1 --


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    log(f"[build] {len(report)} kernels in {time.perf_counter() - t0:.1f} s -> {build.BUILD_DIR}")
    for name, r in report.items():
        log(f"[build] {name}: {r['seconds']:.1f} s  {Path(r['lib']).name}")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"[build]   {line.strip()}")
    # tensor-core instructions in each library's machine code, one cuobjdump each
    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
    procs = {name: subprocess.Popen([cuobjdump, "-sass", r["lib"]], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, r in report.items()}
    sass = {}
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise SmokeError(f"cuobjdump -sass failed on {name}: {out[-500:]}")
        funcs = _sass_functions(out)
        sass[name] = {op: sum(f[op] for f in funcs.values()) for op in TC_OPS}
        log(f"[build] {name}: " + ", ".join(f"{n} {op}" for op, n in sass[name].items())
            + " instructions (cuobjdump -sass)")
        if name == "flash_attention":
            small = {f: c for f, c in funcs.items() if "small_attention_kernel" in f}
            sass["flash_attention_small_head"] = {f: c["HMMA"] for f, c in small.items()}
            log(f"[build] flash_attention: {len(small)} head_dim 8-32 instances, HMMA per "
                f"instance {sorted(c['HMMA'] for c in small.values())}")
            if not small or not all(c["HMMA"] for c in small.values()):
                raise SmokeError("a head_dim 8-32 attention instance has no mma.sync (HMMA) "
                                 f"instructions: { {f[-60:]: c for f, c in small.items()} }")
            # every tensor-core instance, bf16 and float32 (3xTF32), on wgmma
            tc = {f: c["HGMMA"] for f, c in funcs.items() if "tc_attention_kernel" in f}
            sass["flash_attention_tensor_core"] = tc
            log(f"[build] flash_attention: {len(tc)} tensor-core instances, HGMMA per instance "
                f"{sorted(tc.values())}")
            if not tc or not all(tc.values()):
                raise SmokeError("a tensor-core attention instance has no wgmma (HGMMA) "
                                 f"instructions: { {f[-60:]: n for f, n in tc.items()} }")
        if name == "qmatmul":
            wide = {f: c["IGMMA"] for f, c in funcs.items() if "qmatmul_wgmma_kernel" in f}
            stream = {f: c["IMMA"] for f, c in funcs.items() if "qmatmul_stream_kernel" in f}
            sass["qmatmul_by_kernel"] = {**wide, **stream}
            log(f"[build] qmatmul: IGMMA in the wgmma route {sorted(wide.values())}, IMMA per "
                f"streaming instance {sorted(stream.values())}")
            if not wide or not all(wide.values()):
                raise SmokeError("the qmatmul library's wgmma route has no integer wgmma "
                                 f"(IGMMA) instructions: {sass['qmatmul']}")
            if not stream or not all(stream.values()):
                raise SmokeError("a qmatmul streaming instance has no integer mma.sync (IMMA) "
                                 f"instructions: { {f[-60:]: n for f, n in stream.items()} }")
        if name == "ssd_scan":
            mma = {f: c["HMMA"] for f, c in funcs.items()
                   if SSD_PASSES[0] in f or SSD_PASSES[2] in f}
            sass["ssd_scan_by_kernel"] = mma
            log(f"[build] ssd_scan: HMMA per chunk-state / output instance {sorted(mma.values())}")
            if len(mma) < 4 or not all(mma.values()):
                raise SmokeError("an ssd_scan chunk-state or output instance has no mma.sync "
                                 f"(HMMA) instructions: { {f[-60:]: n for f, n in mma.items()} }")
    if not (sass["flash_attention"]["HGMMA"] and sass["flash_attention"]["HMMA"]):
        raise SmokeError("the flash_attention library has no wgmma (HGMMA) or no mma.sync "
                         f"(HMMA) instructions: {sass['flash_attention']}")
    return {n: r["seconds"] for n, r in report.items()}, sass


TC_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA")


def _sass_functions(listing: str) -> dict[str, dict[str, int]]:
    """Tensor-core instruction counts per kernel function of a ``cuobjdump
    -sass`` listing (each function's code follows its ``Function :`` line)."""
    funcs, cur = {}, None
    for ln in listing.splitlines():
        if "Function :" in ln:
            cur = ln.split("Function :", 1)[1].strip()
            funcs[cur] = dict.fromkeys(TC_OPS, 0)
        elif cur is not None and "MMA" in ln:
            words = ln.split(";")[0].split()
            for op in TC_OPS:
                funcs[cur][op] += any(w.startswith(op + ".") or w == op for w in words)
    return funcs


# ---------------------------------------------------------------- phase 2 --


def _attention_case(dev, shape, mode, causal=False, window=None, dtype="float32", hkv=None,
                    sdpa_yardstick=False, v_dim=None, kv_len=None):
    """``mha`` on q, k (b, h / hkv, l, d) and v (b, hkv, l, v_dim): GQA when
    hkv < h; ``v_dim`` is V's own head_dim (MLA: q/k at 96, V at 64), d by
    default; keys past ``kv_len`` masked (with a window that ends before it,
    the rows that see no key give the mean of V in safe mode, as the plain
    version).  SDPA is timed beside the safe softmax, which it computes; with
    ``sdpa_yardstick`` beside the LUT softmax too, as a yardstick of the same
    shape (it computes the exact softmax, not the LUT's).  The bound counts
    the work the function needs (QK^T at d, P.V and the output at v_dim);
    ``padded_bound_ms``, where the kernel zero-pads the head_dims (12, 14,
    80), the padded work's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import mha, mha_ref
    from repro_torch.kernels.flash_attention.ops import cost, kernel_head_dims
    from repro_torch.roofline.kernel_costs import KernelCost, flash_attention

    b, h, l, d = shape
    hkv = h if hkv is None else hkv
    dv = d if v_dim is None else v_dim
    g = torch.Generator().manual_seed(l * d + h)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.randn(b, hh, l, dd, generator=g).to(dev, tdt)
               for hh, dd in ((h, d), (hkv, d), (hkv, dv)))
    kw = dict(causal=causal, window=window, mode=mode, kv_len=kv_len)
    out = mha(q, k, v, **kw)
    ref = mha_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    keyless = 0
    if kv_len is not None and window is not None:
        keyless = max(0, l - (kv_len + window - 1))  # rows that see no key
    flip = None
    if mode == "lut":
        vmax = v.float().abs().amax(dim=-2, keepdim=True).repeat_interleave(h // hkv, dim=1)
        flip = ATT_LUT_STEP * (ref.float().abs() + vmax)
    if dtype == "bfloat16":
        err, rows_over, ok = close_enough(out, ref, BF16_ATOL, BF16_RTOL, flip_allow=flip)
        tol = f"atol {BF16_ATOL} rtol {BF16_RTOL}"
    else:
        err, rows_over, ok = close_enough(out, ref, ATT_ATOL[mode], flip_allow=flip)
        tol = f"atol {ATT_ATOL[mode]}"
    tol += " (+1 table step)" if mode == "lut" else ""

    pos = torch.arange(l)
    mask = torch.ones(l, l, dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    if kv_len is not None:
        mask &= pos[None, :] < kv_len
    # the work the function needs (kernel_costs: the mask's pairs, q, k, v
    # read, out written), every head_dim on the tensor cores
    work = cost(q, k, v, causal=causal, window=window, mode=mode, kv_len=kv_len)
    bound_ms, bound_by = work.bound()
    peak = next(iter(work.flops))
    dk, dvk = kernel_head_dims(d, dv)
    padded_bound_ms = (None if (dk, dvk) == (d, dv) else KernelCost(
        "flash_attention", flash_attention(b, h, hkv, l, l, dk, dvk, q.dtype, causal=causal,
                                           window=window, mode=mode, kv_len=kv_len).flops,
        work.bytes).bound()[0])

    iters = 20 if b * h * l * l * d > 1e8 else 50
    ms = time_ms(lambda: mha(q, k, v, **kw), iters)
    plain_ms = time_ms(lambda: mha_ref(q, k, v, **kw), max(3, iters // 5))
    library_ms = sdpa = None
    if mode == "safe" or sdpa_yardstick:  # timed as a yardstick only
        attn_mask = mask.to(dev) if window is not None or kv_len is not None else None

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                  is_causal=causal and window is None,
                                                  enable_gqa=hkv != h)

        library_ms = time_ms(sdpa, iters)
    # small calls are bound by the host's launch cost: device time beside it
    dev_ms = device_ms(lambda: mha(q, k, v, **kw))
    lib_dev_ms = None if sdpa is None else device_ms(sdpa)
    computes = None if sdpa is None else (
        "the exact softmax" if mode != "safe" else
        "the same function but on rows that see no key (NaN)" if keyless else
        "the same function")
    return dict(kernel="flash_attention", shape=list(shape), kv_heads=hkv, mode=mode,
                causal=causal, window=window, kv_len=kv_len, keyless_rows=keyless,
                dtype=dtype, v_dim=dv, max_abs_err=err,
                rows_over_atol=rows_over, tol=tol, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, device_ms=dev_ms, library_device_ms=lib_dev_ms,
                library_computes=computes,
                bound_ms=bound_ms, bound_by=bound_by, bound_peak=peak,
                padded_bound_ms=padded_bound_ms)


def _ulp(ref):
    """One ulp of a 16-bit ``ref``'s dtype at each |ref| (0 for float32)."""
    import torch

    bits = {torch.bfloat16: 7, torch.float16: 10}.get(ref.dtype)
    if bits is None:
        return 0.0
    r = ref.float().abs().clamp_min(torch.finfo(ref.dtype).tiny)
    return torch.exp2(torch.floor(torch.log2(r)) - bits)


def _layernorm_case(dev, rows, k, rms, use_lut, dtype="float32"):
    """``layernorm`` on x (rows, k) of ``dtype``, with gamma and beta of the
    same dtype (as a model in that dtype holds them)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.layernorm import layernorm, layernorm_ref
    from repro_torch.kernels.layernorm.ops import cost

    g = torch.Generator().manual_seed(rows + k)
    tdt = getattr(torch, dtype)
    x = (torch.randn(rows, k, generator=g) * 3).to(dev, tdt)
    gamma, beta = (torch.randn(k, generator=g).to(dev, tdt) for _ in range(2))
    b_arg = None if rms else beta  # the model path hands RMSNorm no beta
    out = layernorm(x, gamma, b_arg, use_lut=use_lut, rms=rms)
    ref = layernorm_ref(x, gamma, b_arg, use_lut=use_lut, rms=rms)
    torch.cuda.synchronize()
    flip = LN_LUT_STEP * (ref.float().abs() + beta.float().abs()) if use_lut else None
    err, rows_over, ok = close_enough(out, ref, LN_ATOL + _ulp(ref), flip_allow=flip)
    ok = ok and out.dtype == x.dtype
    bound_ms, bound_by = cost(x, gamma, use_lut, rms).bound()  # float32 arithmetic

    def kernel():
        return layernorm(x, gamma, b_arg, use_lut=use_lut, rms=rms)

    iters = 20 if x.numel() > 1e7 else 100
    ms = time_ms(kernel, iters)
    plain_ms = time_ms(lambda: layernorm_ref(x, gamma, b_arg, use_lut=use_lut, rms=rms), iters)
    library = None
    if not use_lut and not rms:
        def library():
            return F.layer_norm(x, (k,), gamma, beta, 1e-5)
    elif not use_lut and hasattr(F, "rms_norm"):
        def library():
            return F.rms_norm(x, (k,), gamma, 1e-5)
    library_ms = None if library is None else time_ms(library, iters)
    dev_ms = device_ms(kernel)
    lib_dev_ms = None if library is None else device_ms(library)
    return dict(kernel="layernorm", shape=[rows, k], mode=("rms" if rms else "ln")
                + ("+lut" if use_lut else ""), dtype=dtype, max_abs_err=err,
                rows_over_atol=rows_over,
                tol=f"atol {LN_ATOL}" + (" + 1 ulp" if dtype != "float32" else "")
                + (" (+1 table step)" if use_lut else ""), ok=ok,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms, device_ms=dev_ms,
                library_device_ms=lib_dev_ms, bound_ms=bound_ms, bound_by=bound_by)


def _qmatmul_case(dev, m, k, n, grid_k=1):
    """``qmatmul_int8`` on seeded codes, with the K-major weight copy as the
    streaming MHA hands it over; the profiler's kernel names are kept."""
    import torch

    from repro_torch.kernels.qmatmul import ROUTES, qmatmul_int8, qmatmul_ref, route
    from repro_torch.roofline import kernel_costs

    g = torch.Generator(device=dev).manual_seed(m + 3 * k + 7 * n)
    x = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    xs = torch.rand(m, 1, generator=g, device=dev) * 0.05 + 1e-3
    ws = torch.rand(1, n, generator=g, device=dev) * 0.05 + 1e-3
    w_kmajor = w.t().contiguous()

    def kernel():
        return qmatmul_int8(x, w, xs, ws, grid_k=grid_k, w_kmajor=w_kmajor)

    path, before = route(k, n), dict(ROUTES)
    out = kernel()
    ref = qmatmul_ref(x, w, xs, ws)
    torch.cuda.synchronize()
    ok = torch.equal(out, ref) and ROUTES[path] == before.get(path, 0) + 1
    err = float((out - ref).abs().max())
    bound_ms, bound_by = kernel_costs.qmatmul(m, k, n).bound()
    iters = 20 if m * n * k > 1e10 else 50
    ms = time_ms(kernel, iters)
    plain_ms = time_ms(lambda: qmatmul_ref(x, w, xs, ws), max(3, iters // 5))
    # Yardstick: torch._int_mm, the int32 product alone (no epilogue), where
    # its shape rules hold.
    library_ms = lib_dev_ms = None
    library_note = "torch._int_mm (int32 product, no epilogue)"
    try:
        library_ms = time_ms(lambda: torch._int_mm(x, w), iters)
        lib_dev_ms = device_ms(lambda: torch._int_mm(x, w))
    except RuntimeError as e:  # a shape _int_mm does not take: no yardstick
        library_note = f"torch._int_mm refused: {str(e).splitlines()[0][:80]}"
    times = device_times(kernel) or {}
    return dict(kernel="qmatmul", shape=[m, k, n], mode=f"R={grid_k}", dtype="int8",
                route=path, device_kernels=sorted(_kernel_label(t) for t in times),
                max_abs_err=err,
                rows_over_atol=float((out != ref).any(dim=-1).float().mean()),
                tol="bitwise", ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library_note=library_note, device_ms=sum(times.values()) or None,
                library_device_ms=lib_dev_ms, bound_ms=bound_ms, bound_by=bound_by)


def _lut_softmax_case(dev, rows, k, fixed):
    import torch

    from repro_torch.core import fixed_point, precision
    from repro_torch.kernels.lut_softmax import lut_softmax, lut_softmax_ref
    from repro_torch.roofline import kernel_costs

    prec = precision.fixed(12, 6) if fixed else None
    g = torch.Generator(device=dev).manual_seed(rows + k)
    x = torch.randn(rows, k, generator=g, device=dev) * 3

    def plain():
        ref = lut_softmax_ref(x)
        return ref if prec is None else fixed_point.quantize(ref, prec.fixed_cfg())

    out, ref = lut_softmax(x, precision=prec), plain()
    torch.cuda.synchronize()
    err = (out - ref).abs()
    allow = SOFTMAX_INV_STEP * ref.abs() + (prec.fixed_cfg().step if fixed else 0.0)
    rows_over = float((err > 0).any(dim=-1).float().mean())
    ok = bool((err <= allow).all()) and rows_over <= FLIP_ROWS
    # about 4 float32 operations per score (index, sum, multiply) against
    # 8 bytes: bound by bytes
    bound_ms, bound_by = kernel_costs.lut_softmax(rows, k).bound()
    iters = 20 if x.numel() > 1e8 else 50
    ms = time_ms(lambda: lut_softmax(x, precision=prec), iters)
    plain_ms = time_ms(plain, max(3, iters // 5))
    return dict(kernel="lut_softmax", shape=[rows, k], mode="fixed<12,6>" if fixed else "none",
                max_abs_err=float(err.max()), rows_over_atol=rows_over,
                tol="bitwise (+1 table step)", ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=None, device_ms=device_ms(lambda: lut_softmax(x, precision=prec)),
                library_device_ms=None, bound_ms=bound_ms, bound_by=bound_by)


def _ssd_case(dev, b, l, h, p, n, groups, chunk, dtype="float32", decay=1.0):
    """``ssd_with_state`` on (b, l, h, p) with B and C per group (``groups``;
    None = per head, the reference ``ssd``'s layout) against the plain
    version on the same inputs, y and final state."""
    import torch

    from repro_torch.core.latency_model import H100
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_with_state
    from repro_torch.kernels.ssd_scan.ops import cost

    gb = h if groups is None else groups
    g = torch.Generator().manual_seed(l + p + n + h)
    tdt = getattr(torch, dtype)
    x = [(torch.randn(b, l, h, p, generator=g) * 0.5),
         -torch.randn(b, l, h, generator=g).abs() * 0.3 * decay,
         torch.randn(b, l, gb, n, generator=g) * 0.5,
         torch.randn(b, l, gb, n, generator=g) * 0.5]
    x = [t.to(dev, tdt) for t in x]
    q = min(chunk, l)

    def plain():
        rep = h // gb
        return ssd_chunked(x[0].float(), x[1].float(), x[2].float().repeat_interleave(rep, 2),
                           x[3].float().repeat_interleave(rep, 2), chunk=q)

    y, state = ssd_with_state(*x, chunk=chunk)
    y_ref, s_ref = plain()
    torch.cuda.synchronize()
    if dtype == "bfloat16":
        err_y, _, ok_y = close_enough(y, y_ref.to(tdt), BF16_ATOL, BF16_RTOL)
        tol = f"y atol {BF16_ATOL} rtol {BF16_RTOL}, state atol {SSD_ATOL}"
    else:
        err_y, _, ok_y = close_enough(y, y_ref, SSD_ATOL)
        tol = f"atol {SSD_ATOL} (y and state)"
    err_s, _, ok_s = close_enough(state, s_ref, SSD_ATOL)
    ok = ok_y and ok_s and bool(torch.isfinite(y).all() and torch.isfinite(state).all())
    # the lower triangles of C B^T (per group) and G xdt, C S_in and the chunk
    # state (per head); float32 as 3xTF32.  Each input read once, y and the
    # final state written once (kernel_costs.ssd_scan)
    es = x[0].element_size()
    nc = l // q
    work = cost(x[0], x[2], chunk)
    flops, nbytes = work.total_flops, work.bytes
    bound_ms, bound_by = work.bound()
    # the three-pass design's own floor: the chunk states (b nc h P N float32)
    # written, read and rewritten, read; xdt, a and B read twice, C once
    scratch = 4 * b * nc * h * p * n
    floor_bytes = 4 * scratch + nbytes + es * (b * l * h * p + b * l * h + b * l * gb * n)
    iters = 10 if flops > 1e10 else 50
    ms = time_ms(lambda: ssd_with_state(*x, chunk=chunk), iters)
    plain_ms = time_ms(plain, max(3, iters // 5))
    times = device_times(lambda: ssd_with_state(*x, chunk=chunk)) or {}
    passes = {name: sum(t for k, t in times.items() if name in k) for name in SSD_PASSES}
    dev_ms = sum(times.values()) or None
    return dict(kernel="ssd_scan", shape=[b * h, l, p, n], mode=f"q{q} g{gb}"
                + (f" a*{decay:g}" if decay != 1.0 else ""), dtype=dtype,
                max_abs_err=max(err_y, err_s), max_abs_err_state=err_s, rows_over_atol=0.0,
                tol=tol, ok=ok, ms=ms, plain_ms=plain_ms, library_ms=None,
                device_ms=dev_ms, library_device_ms=None, pass_device_ms=passes,
                scratch_bytes=scratch, floor_ms=floor_bytes / H100.hbm_bw * 1e3,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_kernels(dev):
    from repro_torch.configs import get_config

    cases = []
    for name in MODELS:  # the shapes the main path gives the kernels at batch 8192
        cfg = get_config(name)
        shape = (8192, cfg.n_heads, cfg.seq_len, cfg.resolved_head_dim)
        for mode in ("safe", "lut"):
            cases.append(_attention_case(dev, shape, mode))
        if name != "engine_anomaly":  # btagging and gw in bf16
            cases.append(_attention_case(dev, shape, "safe", dtype="bfloat16"))
    for d in (64, 128):  # LM-like
        for mode in ("safe", "lut"):
            cases.append(_attention_case(dev, (1, 8, 1024, d), mode, causal=True))
            cases.append(_attention_case(dev, (1, 8, 1024, d), mode, causal=True, window=256))
        cases.append(_attention_case(dev, (1, 8, 1024, d), "safe", causal=True,
                                     dtype="bfloat16"))
    # the main path's own attention shapes: granite-8b's streaming MHA (phase 4,
    # float32 causal, safe and lut) and a dense GQA prefill (32 q / 8 kv heads)
    for mode in ("safe", "lut"):
        cases.append(_attention_case(dev, (1, 32, 1024, 128), mode, causal=True))
    cases.append(_attention_case(dev, (1, 32, 1024, 128), "safe", causal=True, dtype="bfloat16"))
    for dtype in ("bfloat16", "float32"):
        cases.append(_attention_case(dev, (1, 32, 2048, 128), "safe", causal=True, dtype=dtype,
                                     hkv=8))
    # the dense LM path's (phase 6): granite-8b's prefill at batch 8,
    # minicpm-2b's (36 heads x 64), starcoder2-7b's window of 4096 over 8192
    # tokens (36 q / 4 kv heads), and their norms at 8 x 2048 rows
    cases.append(_attention_case(dev, (8, 32, 2048, 128), "safe", causal=True,
                                 dtype="bfloat16", hkv=8))
    cases.append(_attention_case(dev, (1, 36, 2048, 64), "safe", causal=True, dtype="bfloat16"))
    cases.append(_attention_case(dev, (1, 36, 8192, 128), "safe", causal=True, window=4096,
                                 dtype="bfloat16", hkv=4))
    cases.append(_layernorm_case(dev, 8 * 2048, 4096, True, False, "bfloat16"))
    cases.append(_layernorm_case(dev, 8 * 2048, 4608, False, False, "bfloat16"))
    cases += _int8_moe_kernel_cases(dev)  # phase 9's shapes
    cases += _mla_kernel_cases(dev)  # phase 10's
    cases += _families_kernel_cases(dev)  # phase 11's
    ln_shapes = [(8192 * 15, 64), (8192 * 100, 32), (4096, 4096)]
    for rows, k in ln_shapes:
        for rms in (False, True):
            for use_lut in (False, True):
                cases.append(_layernorm_case(dev, rows, k, rms, use_lut))
    for rows, k in ln_shapes[:2]:  # the physics shapes in bf16, and one in fp16
        for use_lut in (False, True):
            cases.append(_layernorm_case(dev, rows, k, False, use_lut, "bfloat16"))
    cases.append(_layernorm_case(dev, 8192 * 100, 32, False, False, "float16"))
    for rms in (False, True):
        cases.append(_layernorm_case(dev, 4096, 4096, rms, False, "bfloat16"))
    # mamba2-130m's RMSNorms (ln1 and the final norm at 768, gate_norm at
    # 1536) at the rows of phase 5: decode at batch 1, 2 and 8, prefill of
    # 2 x 256, 1 x 2048 and 8 x 2048; float32 (the check) and bf16 (the config)
    for dtype in ("float32", "bfloat16"):
        for k in (768, 1536):
            for rows in (1, 2, 8, 2 * 256, 2048, 8 * 2048):
                cases.append(_layernorm_case(dev, rows, k, True, False, dtype))
    # head_dims the kernel pads: 12 to 16 (minicpm-2b reduced), 80 to 128
    # (hubert-xlarge); 16 itself beside them
    for d in (12, 16, 80):
        cases.append(_attention_case(dev, (1, 8, 1024, d), "safe", causal=True))
    for name in MODELS:  # stage 1/4 GEMMs of the streaming MHA at batch 8192
        cfg = get_config(name)
        cases.append(_qmatmul_case(dev, 8192 * cfg.seq_len, cfg.d_model, cfg.d_model))
    cases.append(_qmatmul_case(dev, 4096, 4096, 4096))
    for r in (1, 2, 4, 8):  # the reuse factor R: every output bitwise equal
        cases.append(_qmatmul_case(dev, 1024, 4096, 4096, grid_k=r))
    for name in MODELS:  # attention scores (B*H*L, L) at batch 8192
        cfg = get_config(name)
        for fixed in (False, True):
            cases.append(_lut_softmax_case(dev, 8192 * cfg.n_heads * cfg.seq_len,
                                           cfg.seq_len, fixed))
    for fixed in (False, True):
        cases.append(_lut_softmax_case(dev, 8192, 1024, fixed))
    for chunk in (8, 16, 32, 64):  # the JAX kernel test's sweep (per-head B, C)
        cases.append(_ssd_case(dev, 2, 64, 3, 16, 24, None, chunk))
    for b, l, h, p, n in ((1, 32, 1, 8, 8), (2, 128, 2, 32, 16), (1, 64, 4, 64, 64)):
        cases.append(_ssd_case(dev, b, l, h, p, n, None, 32))
    cases.append(_ssd_case(dev, 2, 64, 3, 16, 24, None, 16, decay=50.0))  # strong decay
    cases.append(_ssd_case(dev, 2, 12, 3, 16, 24, None, 64))  # l < chunk
    cases.append(_ssd_case(dev, 2, 256, 8, 8, 16, 1, 16))  # mamba2-130m-reduced
    for dtype in ("float32", "bfloat16"):  # mamba2-130m's prefill at 2048 tokens
        for b in MAMBA_TIME_BATCHES:
            cases.append(_ssd_case(dev, b, 2048, 24, 64, 128, 1, 64, dtype=dtype))
    _report_cases(cases)
    return cases


def _int8_moe_kernel_cases(dev) -> list[dict]:
    """The int8_serve / MoE path's kernel cases (phase 9): granite-moe-3b-a800m's
    prefill attend at 8 x 2048, 24 q / 8 kv heads of 64, LUT softmax, in bf16
    and in float32 (the route under the int8 KV cache), SDPA beside it as a
    yardstick; its RMSNorm (d 1536) at 8 x 2048 rows."""
    cases = [_attention_case(dev, (8, 24, 2048, 64), "lut", causal=True, dtype=dtype, hkv=8,
                             sdpa_yardstick=True) for dtype in ("bfloat16", "float32")]
    return cases + [_layernorm_case(dev, 8 * 2048, 1536, True, False, "bfloat16")]


def _mla_kernel_cases(dev) -> list[dict]:
    """The MLA path's kernel cases (phase 10): minicpm3-4b's prefill attend at
    8 x 2048, 40 heads at a q/k head_dim of 96 and V at 64, the kernel's
    native (96, 64) instance, causal: bf16 safe (float) and float32 LUT
    (int8_serve's dequantized latent); its q_norm (768) and kv_norm (256)
    RMSNorms at 8 x 2048 rows."""
    cases = [_attention_case(dev, MLA_ATTENTION, "safe", causal=True, dtype="bfloat16",
                             v_dim=64),
             _attention_case(dev, MLA_ATTENTION, "lut", causal=True, dtype="float32",
                             sdpa_yardstick=True, v_dim=64)]
    return cases + [_layernorm_case(dev, 8 * 2048, k, True, False, "bfloat16")
                    for k in (768, 256)]


def _report_cases(cases):
    """Log one line per kernel case (and the ssd_scan passes' shares); raise
    if any case disagrees with its plain version."""
    for c in cases:
        lib = "n/a" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        dev_t = ""
        if c.get("device_ms") is not None:
            lib_dev = c["library_device_ms"]
            dev_t = (f" | device ms {c['device_ms']:.4f} library "
                     f"{'n/a' if lib_dev is None else f'{lib_dev:.4f}'}")
        kv = f" kv {c['kv_heads']}" if c.get("kv_heads", c["shape"][1]) != c["shape"][1] else ""
        mode = c["mode"] + (f" {c['route']}" if "route" in c else "")
        if c.get("padded_bound_ms") is not None:
            dev_t += f" | padded bound {c['padded_bound_ms']:.4f}"
        if c.get("kv_len") is not None:
            kv += f" kv_len {c['kv_len']} ({c['keyless_rows']} rows see no key)"
        log(f"[kernel] {c['kernel']:15s} {str(c['shape']) + kv:22s} {mode:6s} "
            f"causal={c.get('causal', '-')!s:5s} window={c.get('window', '-')!s:4s} "
            f"{c.get('dtype', 'float32'):8s} err {c['max_abs_err']:.2e} ({c['tol']}; "
            f"{c['rows_over_atol']:.3%} rows over atol) "
            f"{'OK' if c['ok'] else 'FAIL'} | ms {c['ms']:.4f} plain {c['plain_ms']:.4f} "
            f"library {lib} bound {c['bound_ms']:.4f} ({c['bound_by']}){dev_t}")
    for c in cases:
        if c["kernel"] == "ssd_scan" and c["device_ms"]:
            shares = ", ".join(f"{k.removeprefix('ssd_').removesuffix('_kernel')} "
                               f"{v / c['device_ms']:.1%}" for k, v in c["pass_device_ms"].items())
            log(f"[ssd] {str(c['shape']):22s} {c['mode']:10s} {c['dtype']:8s} device ms "
                f"{c['device_ms']:.4f} ({shares}); scratch {c['scratch_bytes'] / 1e6:.1f} MB, "
                f"three-pass floor {c['floor_ms']:.4f} ms; bound {c['bound_ms']:.4f} ms")
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SmokeError(f"{len(bad)} kernel checks out of tolerance: "
                         + "; ".join(f"{c['kernel']} {c['shape']} {c['mode']}" for c in bad))


# ---------------------------------------------------------------- phase 3 --


def phase_models(dev):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import precision
    from repro_torch.data import GENERATORS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import physics

    results = []
    LAUNCHES.clear()  # main-path window starts here
    for name in MODELS:
        events, _ = GENERATORS[name](max(BATCHES), seed=SEED)
        for policy in POLICIES:
            cfg = dataclasses.replace(get_config(name), precision=policy)
            params = physics.init_params(cfg, torch.Generator().manual_seed(SEED), device=dev)
            params = precision.apply_plan_to_params(params, precision.resolve_model_plan(cfg))
            params_cpu = _to(params, "cpu")
            per_fwd = {
                "flash_attention": cfg.n_layers,
                "layernorm": 0 if cfg.norm_kind == "none" else 2 * cfg.n_layers + 1,
            }
            for batch in BATCHES:
                x = torch.from_numpy(events[:batch]).to(dev)
                before = dict(LAUNCHES)
                logits = physics.forward(params, cfg, x, device=dev)
                torch.cuda.synchronize()
                for kname, n in per_fwd.items():
                    grew = LAUNCHES[kname] - before.get(kname, 0)
                    if grew != n:
                        raise SmokeError(f"{name}/{policy}: {kname} launched {grew} times "
                                         f"in one forward, expected {n}")
                if logits.shape != (batch, cfg.n_classes) or not torch.isfinite(logits).all():
                    raise SmokeError(f"{name}/{policy}/b{batch}: bad logits {tuple(logits.shape)}")
                n_chk = min(batch, CPU_CHECK_EVENTS)
                ref = physics.forward(params_cpu, cfg, events[:n_chk], device="cpu")
                err = (logits[:n_chk].cpu() - ref).abs().amax(dim=-1)
                tol = MODEL_TOL[policy]
                frac_over = float((err > tol).float().mean())
                ok = float(err.max()) <= tol or (policy != "float" and frac_over <= MODEL_FLIP_EVENTS
                                                 and float(err.max()) <= MODEL_FLIP_CAP)
                if not ok:
                    raise SmokeError(f"{name}/{policy}/b{batch}: logits differ from the CPU "
                                     f"path by {float(err.max()):.3e} (tol {tol}), "
                                     f"{frac_over:.4%} of events over")
                iters = 200 if batch == 1 else 30
                ms = median_ms(lambda: physics.forward(params, cfg, x, device=dev), iters)
                prof = profile_forward(lambda: physics.forward(params, cfg, x, device=dev))
                r = dict(model=name, policy=policy, batch=batch, median_ms=ms, profile=prof,
                         events_per_s=batch / (ms * 1e-3), max_abs_err_vs_cpu=float(err.max()),
                         events_checked=n_chk, frac_over_tol=frac_over, tol=tol,
                         launches_per_forward=per_fwd)
                results.append(r)
                log(f"[model] {name:14s} {policy:11s} batch {batch:5d}  median {ms:.4f} ms  "
                    f"{r['events_per_s']:.1f} events/s  |logits - cpu| {r['max_abs_err_vs_cpu']:.2e} "
                    f"(tol {tol}, {n_chk} events)  launches/fwd {per_fwd}")
                busy = prof["busy_share"]
                log(f"[profile] {name:14s} {policy:11s} batch {batch:5d}  device busy "
                    f"{'not measured' if busy is None else f'{busy:.1%}'}  "
                    f"device ms/fwd {prof.get('device_ms_per_fwd', float('nan')):.4f}  "
                    f"top {prof['top']}")
    counts = dict(LAUNCHES)  # main-path window ends here
    for kname in ("flash_attention", "layernorm"):
        if counts.get(kname, 0) <= 0:
            raise SmokeError(f"{kname} was never launched on the main path")
    log(f"[model] main-path launches: {counts}")
    return results, counts


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------- phase 4 --


def _mha_inputs(name: str):
    """(x (batch, seq, d_model) float32 on the CPU, weights, n_heads, causal)
    for an encoder, from its seeded events through a seeded input embedding,
    or random activations at granite-8b's width."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import GENERATORS

    g = torch.Generator().manual_seed(SEED)
    if name == "granite-8b":
        d, h, seq, causal = GRANITE
        x = torch.randn(1, seq, d, generator=g)
    else:
        cfg = get_config(name)
        d, h, causal = cfg.d_model, cfg.n_heads, False  # encoders attend both ways
        events, _ = GENERATORS[name](max(BATCHES), seed=SEED)
        w_in = torch.randn(events.shape[-1], d, generator=g) / np.sqrt(events.shape[-1])
        x = torch.from_numpy(events) @ w_in
    ws = [torch.randn(d, d, generator=g) / np.sqrt(d) for _ in range(4)]
    return x, ws, h, causal


def _mha_stages_match(x, params, params_cpu, h, causal, mode) -> bool:
    """Stages 1 and 4 on the card bitwise equal to the CPU path's, given the
    same inputs (stage 4: the card's own attention output).  The launches
    made here are comparisons and are taken off the counts again."""
    import torch

    from repro_torch.core.streaming_mha import split_heads, int8_linear
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import mha

    saved = dict(LAUNCHES)
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    same = True
    qkv = []
    for name in ("q", "k", "v"):
        w, bias = getattr(params, "w" + name), getattr(params, "b" + name)
        w_cpu, bias_cpu = getattr(params_cpu, "w" + name), getattr(params_cpu, "b" + name)
        t = int8_linear(flat, w, bias, params.kmajor["w" + name])
        same &= torch.equal(t.cpu(), int8_linear(flat.cpu(), w_cpu, bias_cpu))
        qkv.append(split_heads(t, b, s, h))
    o = mha(*qkv, causal=causal, mode=mode).transpose(1, 2).reshape(b * s, -1)
    out = int8_linear(o, params.wo, params.bo, params.kmajor["wo"])
    same &= torch.equal(out.cpu(), int8_linear(o.cpu(), params_cpu.wo, params_cpu.bo))
    torch.cuda.synchronize()
    LAUNCHES.clear()
    LAUNCHES.update(saved)
    return bool(same)


def phase_mha(dev):
    import torch

    from repro_torch.core.streaming_mha import (
        quantize_mha_params,
        streaming_mha,
        streaming_mha_float_ref,
    )
    from repro_torch.kernels import LAUNCHES

    results = []
    LAUNCHES.clear()  # the streaming-MHA path's window starts here
    for name in (*MODELS, "granite-8b"):
        x_all, ws, h, causal = _mha_inputs(name)
        ws_dev = [w.to(dev) for w in ws]
        params = quantize_mha_params(*ws_dev)
        params_cpu = quantize_mha_params(*ws)
        batches = (1,) if name == "granite-8b" else BATCHES
        for mode in ("lut", "safe"):
            for batch in batches:
                x = x_all[:batch].to(dev)

                def call():
                    return streaming_mha(x, params, n_heads=h, causal=causal, softmax_mode=mode)

                before = dict(LAUNCHES)
                out = call()
                torch.cuda.synchronize()
                grew = {k: LAUNCHES[k] - before.get(k, 0) for k in ("qmatmul", "flash_attention")}
                if grew != {"qmatmul": 4, "flash_attention": 1}:
                    raise SmokeError(f"mha {name}/{mode}/b{batch}: launches per call {grew}, "
                                     "expected 4 qmatmul and 1 flash_attention")
                if out.shape != x.shape or not torch.isfinite(out).all():
                    raise SmokeError(f"mha {name}/{mode}/b{batch}: bad output {tuple(out.shape)}")
                n_chk = min(batch, CPU_CHECK_EVENTS)
                if not _mha_stages_match(x[:n_chk], params, params_cpu, h, causal, mode):
                    raise SmokeError(f"mha {name}/{mode}/b{batch}: stage 1 or 4 differs from "
                                     "the CPU path on the same inputs")
                ref = streaming_mha(x_all[:n_chk], params_cpu, n_heads=h, causal=causal,
                                    softmax_mode=mode)
                diff = out[:n_chk].cpu() - ref
                err = float(diff.abs().max())
                over = float((diff.abs().amax(dim=-1) > MHA_TOL).float().mean())
                rel_cpu = float(diff.norm() / ref.norm())
                if not rel_cpu < MHA_REL_VS_CPU:
                    raise SmokeError(f"mha {name}/{mode}/b{batch}: {rel_cpu:.2e} from the CPU "
                                     f"path (bound {MHA_REL_VS_CPU}); max {err:.3e}")
                oracle = streaming_mha_float_ref(x, *ws_dev, n_heads=h, causal=causal)
                rel = float((out - oracle).norm() / oracle.norm())
                if not rel < MHA_FLOAT_REL:
                    raise SmokeError(f"mha {name}/{mode}/b{batch}: {rel:.3f} from the float "
                                     f"oracle (bound {MHA_FLOAT_REL})")
                iters = 200 if batch == 1 and name != "granite-8b" else 30
                ms = median_ms(call, iters)
                prof = profile_forward(call)
                r = dict(model=name, softmax=mode, batch=batch, seq=x.shape[1],
                         d_model=x.shape[2], n_heads=h, causal=causal, median_ms=ms,
                         events_per_s=batch / (ms * 1e-3), max_abs_err_vs_cpu=err,
                         rel_vs_cpu=rel_cpu, tokens_over_1e4=over, events_checked=n_chk,
                         stages_1_4_bitwise=True, rel_vs_float=rel,
                         profile=prof)
                results.append(r)
                busy = prof["busy_share"]
                log(f"[mha] {name:14s} {mode:4s} batch {batch:5d} (seq {x.shape[1]}, d "
                    f"{x.shape[2]}, {h} heads)  median {ms:.4f} ms  {r['events_per_s']:.1f} "
                    f"events/s  stages 1+4 bitwise  |out - cpu| {err:.2e} (rel {rel_cpu:.1e}, "
                    f"{over:.3%} tokens over {MHA_TOL}, {n_chk} events)  rel vs float "
                    f"{rel:.4f}  device busy "
                    f"{'not measured' if busy is None else f'{busy:.1%}'}"
                    + ("" if busy is None else f"  device ms/call {prof['device_ms_per_fwd']:.4f}"
                       f", qmatmul share {prof['qmatmul_share']:.1%}")
                    + f"  top {prof['top']}")
    counts = dict(LAUNCHES)  # the streaming-MHA path's window ends here
    for kname in ("qmatmul", "flash_attention"):
        if counts.get(kname, 0) <= 0:
            raise SmokeError(f"{kname} was never launched on the streaming-MHA path")
    log(f"[mha] streaming-MHA path launches: {counts}")
    return results, counts


def phase_lut_softmax_path(dev):
    """The LUT softmax entry point on the encoders' attention scores at
    batch 8192 (Q K^T / sqrt(d) of the streaming MHA's stage-1 projections),
    with the paper's ap_fixed<12,6> output."""
    import torch

    from repro_torch.core import fixed_point, precision
    from repro_torch.core.streaming_mha import split_heads, int8_linear, quantize_mha_params
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.lut_softmax import lut_softmax, lut_softmax_ref

    prec = precision.fixed(12, 6)
    scores = {}
    for name in MODELS:  # inputs, made before the path's window
        x_all, ws, h, _ = _mha_inputs(name)
        p = quantize_mha_params(*(w.to(dev) for w in ws))
        b, s, d = x_all.shape
        flat = x_all.to(dev).reshape(b * s, d)
        q, k = (split_heads(int8_linear(flat, w, None), b, s, h) for w in (p.wq, p.wk))
        scores[name] = (q @ k.transpose(-1, -2)) / (d // h) ** 0.5
    results = []
    LAUNCHES.clear()  # the LUT softmax path's window starts here
    for name, sc in scores.items():
        out = lut_softmax(sc, precision=prec)
        torch.cuda.synchronize()
        ref = fixed_point.quantize(lut_softmax_ref(sc), prec.fixed_cfg())
        err = (out - ref).abs()
        rows_over = float((err > 0).reshape(-1, sc.shape[-1]).any(dim=-1).float().mean())
        allow = SOFTMAX_INV_STEP * ref.abs() + prec.fixed_cfg().step
        if not (bool((err <= allow).all()) and rows_over <= FLIP_ROWS):
            raise SmokeError(f"lut_softmax on {name}'s scores: {float(err.max()):.3e}, "
                             f"{rows_over:.3%} rows differ")
        rows_sum = float((out.sum(-1) - 1).abs().max())
        results.append(dict(model=name, shape=list(sc.shape), max_abs_err=float(err.max()),
                            rows_over=rows_over, max_row_sum_dev=rows_sum))
        log(f"[lut_softmax] {name:14s} scores {tuple(sc.shape)}  err vs plain "
            f"{float(err.max()):.2e} ({rows_over:.4%} rows differ)  max |row sum - 1| "
            f"{rows_sum:.3f}")
    counts = dict(LAUNCHES)  # the LUT softmax path's window ends here
    if counts.get("lut_softmax", 0) != len(scores):
        raise SmokeError(f"lut_softmax launched {counts.get('lut_softmax', 0)} times on its "
                         f"path, expected {len(scores)}")
    return results, counts


# ---------------------------------------------------------------- phase 5 --


def _norm_with_casts(params, x, kind, eps=1e-5, use_lut=False):
    """``models.layers.norm`` with float32 casts around the kernel (x, scale
    and bias to float32 before it, the output back to x's dtype after it):
    the norm as the models called it while the kernel took float32 only."""
    from repro_torch.kernels.layernorm import layernorm

    if kind == "none":
        return x
    out = layernorm(x.float().contiguous(), params["scale"].float(),
                    params["bias"].float() if kind == "layernorm" else None,
                    use_lut=use_lut, rms=kind == "rmsnorm", eps=eps)
    return out.to(x.dtype)


def _device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) that one call of ``fn``
    runs, counted by the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _launch_checker(label, per_call):
    """``checked(kind, fn)``: run ``fn`` and raise unless each kernel of
    ``per_call[kind]`` was launched exactly that many times."""
    import torch

    from repro_torch.kernels import LAUNCHES

    def checked(kind, fn):
        before = dict(LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        grew = {k: LAUNCHES[k] - before.get(k, 0) for k in per_call[kind]}
        if grew != per_call[kind]:
            raise SmokeError(f"{label} {kind}: launches per call {grew}, expected {per_call[kind]}")
        return out

    return checked


def _greedy_check(label, cfg, params, params_cpu, prompt, steps, checked, tol,
                  patches=None) -> dict:
    """Greedy decode on the card from ``prompt`` (float32 caches of prompt +
    ``steps`` tokens; a VLM's ``patches`` before it), held against the
    port's CPU path on the same weights fed the card's tokens (logits within
    ``tol``; a token may differ only where the CPU path's top-two margin is
    below ``tol``) and against one ``forward`` over the whole sequence
    (continuity).  ``checked(kind, fn)`` runs a prefill or decode call and
    checks its launches.  Raises on a failure; returns the check's
    record."""
    import torch

    from repro_torch.models import lm

    dev = params["embed"]["table"].device
    b, s0 = prompt.shape
    off = 0 if patches is None else patches.shape[1]  # the image prefix
    image = {} if patches is None else {"patches": patches.to(dev)}
    max_len = off + s0 + steps
    caches = lm.init_caches(cfg, b, max_len, torch.float32, device=dev)
    last, caches = checked("prefill", lambda: lm.prefill(
        params, cfg, {"tokens": prompt.to(dev), **image}, caches, device=dev))
    card, toks = [last.cpu()], []
    for k in range(steps):
        tok = last.argmax(-1, keepdim=True)
        toks.append(tok.cpu())
        pos = torch.full((b,), off + s0 + k, dtype=torch.int32, device=dev)
        last, caches = checked("decode", lambda: lm.decode_step(
            params, cfg, tok, pos, caches, device=dev))
        card.append(last.cpu())
    card = torch.stack(card, 1)  # (b, steps + 1, V): positions s0 - 1 .. s0 + steps - 1
    seq = torch.cat([prompt, *toks], dim=1)
    full, _, _ = checked("prefill", lambda: lm.forward(
        params, cfg, {"tokens": seq.to(dev), **image}, device=dev))
    cont_err = float((full[:, off + s0 - 1:].cpu() - card).abs().max())
    # ... and the port's CPU path on the same weights, fed the card's tokens
    image = {} if patches is None else {"patches": patches.cpu()}
    c_last, c_caches = lm.prefill(params_cpu, cfg, {"tokens": prompt, **image},
                                  lm.init_caches(cfg, b, max_len, torch.float32, device="cpu"),
                                  device="cpu")
    cpu = [c_last]
    for k in range(steps):
        c_last, c_caches = lm.decode_step(params_cpu, cfg, toks[k],
                                          torch.full((b,), off + s0 + k), c_caches,
                                          device="cpu")
        cpu.append(c_last)
    cpu = torch.stack(cpu, 1)
    cpu_err = float((card - cpu).abs().max())
    greedy_cpu = cpu[:, :-1].argmax(-1)
    greedy_card = torch.cat(toks, dim=1)
    differ = (greedy_cpu != greedy_card).nonzero().tolist()
    top2 = cpu[:, :-1].topk(2, dim=-1).values
    margins = top2[..., 0] - top2[..., 1]
    close_calls = [dict(seq=i, step=k, cpu_margin=float(margins[i, k])) for i, k in differ]
    if any(c["cpu_margin"] >= tol for c in close_calls):
        raise SmokeError(f"{label} greedy tokens differ from the CPU path at {close_calls}")
    if not (torch.isfinite(card).all() and card.shape == (b, steps + 1, cfg.padded_vocab_size)):
        raise SmokeError(f"{label}: bad logits {tuple(card.shape)}")
    if cpu_err > tol or cont_err > tol:
        raise SmokeError(f"{label} float32: |card - cpu| {cpu_err:.3e}, |decode - forward| "
                         f"{cont_err:.3e} (tol {tol})")
    return dict(batch=b, prompt=s0, image_tokens=off, steps=steps, max_abs_err_vs_cpu=cpu_err,
                max_abs_err_decode_vs_forward=cont_err, tol=tol,
                greedy_differs_at_close_calls=close_calls,
                min_cpu_top2_margin=float(margins.min()))


def phase_mamba(dev):
    """mamba2-130m through ``models.lm``: the float32 check, then the
    bfloat16 timings.  Returns (results, launch counts of the window)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import layers, lm

    base = dataclasses.replace(get_config(MAMBA), n_layers=MAMBA_LAYERS)
    cfg = dataclasses.replace(base, dtype="float32")
    n_ln = 2 * cfg.n_layers + 1
    per_call = {"prefill": {"ssd_scan": cfg.n_layers, "layernorm": n_ln},
                "decode": {"ssd_scan": 0, "layernorm": n_ln}}
    b, s0, steps = MAMBA_CHECK
    params_cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    params = _to(params_cpu, dev)
    prompt = torch.randint(0, cfg.vocab_size, (b, s0), generator=torch.Generator().manual_seed(1))
    params_bf16 = lm.init_params(base, torch.Generator().manual_seed(SEED), device=dev)
    t_gen = torch.Generator(device=dev).manual_seed(2)
    t_toks = {bt: torch.randint(0, base.vocab_size, (bt, MAMBA_TIME_LEN), generator=t_gen,
                                device=dev) for bt in MAMBA_TIME_BATCHES}

    checked = _launch_checker("mamba", per_call)

    LAUNCHES.clear()  # the mamba path's window starts here
    check = _greedy_check(MAMBA, cfg, params, params_cpu, prompt, steps, checked, MAMBA_TOL)
    check["launches_per_call"] = per_call
    log(f"[mamba] float32 check: {cfg.n_layers} layers d {cfg.d_model}, {b} x {s0} prompt + "
        f"{steps} greedy steps  |card - cpu| {check['max_abs_err_vs_cpu']:.2e}  "
        f"|decode - forward({s0 + steps})| {check['max_abs_err_decode_vs_forward']:.2e} "
        f"(tol {MAMBA_TOL})  tokens differ at "
        f"{check['greedy_differs_at_close_calls'] or 'no step'}  launches/call {per_call}")

    # bfloat16 timings
    timings = []
    for bt in MAMBA_TIME_BATCHES:
        caches = lm.init_caches(base, bt, MAMBA_TIME_LEN + MAMBA_TIME_STEPS, device=dev)
        tk = t_toks[bt]

        def prefill():
            return lm.prefill(params_bf16, base, {"tokens": tk}, caches, device=dev)

        last, filled = checked("prefill", prefill)
        if not torch.isfinite(last.float()).all():
            raise SmokeError(f"mamba bf16 prefill b{bt}: non-finite logits")
        ms = median_ms(prefill, 5 if bt > 1 else 10, warmup=2)
        prof = profile_forward(prefill, iters=3)
        timings.append(dict(kind="prefill", batch=bt, tokens=MAMBA_TIME_LEN, median_ms=ms,
                            tokens_per_s=bt * MAMBA_TIME_LEN / (ms * 1e-3), profile=prof))
        start_tok = last.argmax(-1, keepdim=True)

        def decode_run():
            tok, c = start_tok, filled
            for k in range(MAMBA_TIME_STEPS):
                pos = torch.full((bt,), MAMBA_TIME_LEN + k, dtype=torch.int32, device=dev)
                lg, c = lm.decode_step(params_bf16, base, tok, pos, c, device=dev)
                tok = lg.argmax(-1, keepdim=True)
            return tok

        def one_step():
            return lm.decode_step(params_bf16, base, start_tok,
                                  torch.full((bt,), MAMBA_TIME_LEN, device=dev), filled,
                                  device=dev)

        checked("decode", one_step)
        run_ms = median_ms(decode_run, 3, warmup=1)
        dprof = profile_forward(decode_run, iters=1)
        # the same step with float32 casts around each norm, for comparison:
        # its launches are taken off the counts again
        ops_step = _device_ops(one_step)
        saved, plain_norm = dict(LAUNCHES), layers.norm
        layers.norm = _norm_with_casts
        try:
            ops_casts = _device_ops(one_step)
            casts_ms = median_ms(decode_run, 3, warmup=1)
        finally:
            layers.norm = plain_norm
            LAUNCHES.clear()
            LAUNCHES.update(saved)
        timings.append(dict(kind="decode", batch=bt, steps=MAMBA_TIME_STEPS,
                            ms_per_token=run_ms / MAMBA_TIME_STEPS,
                            tokens_per_s=bt * MAMBA_TIME_STEPS / (run_ms * 1e-3), profile=dprof,
                            device_ops_per_step=ops_step,
                            device_ops_per_step_with_casts=ops_casts,
                            ms_per_token_with_casts=casts_ms / MAMBA_TIME_STEPS))
    for t in timings:
        busy = t["profile"]["busy_share"]
        what = (f"prefill {t['batch']} x {t['tokens']}  median {t['median_ms']:.3f} ms"
                if t["kind"] == "prefill" else
                f"decode batch {t['batch']}  {t['ms_per_token']:.3f} ms/token, "
                f"{t['device_ops_per_step']} device ops/step (with float32 casts around the "
                f"norms: {t['device_ops_per_step_with_casts']}, "
                f"{t['ms_per_token_with_casts']:.3f} ms/token)")
        prof = t["profile"]
        dev_t = ("" if busy is None else f"  device ms {prof['device_ms_per_fwd']:.3f}, "
                 f"ssd_scan share {prof['ssd_scan_share']:.1%}")
        log(f"[mamba] bf16 {what}  {t['tokens_per_s']:.1f} tokens/s  device busy "
            f"{'not measured' if busy is None else f'{busy:.1%}'}{dev_t}  top {prof['top']}")
    counts = dict(LAUNCHES)  # the mamba path's window ends here
    for kname in ("ssd_scan", "layernorm"):
        if counts.get(kname, 0) <= 0:
            raise SmokeError(f"{kname} was never launched on the mamba path")
    log(f"[mamba] mamba path launches: {counts}")
    return dict(check=check, timings=timings), counts


# ---------------------------------------------------------------- phase 6 --


def _dense_check_configs():
    """(label, float32 config) of phase 6a: the published widths, 2 layers,
    a vocab of 512; starcoder2-7b again with a window its check passes."""
    from repro_torch.configs import get_config

    cfgs = [(name, dataclasses.replace(get_config(name), **DENSE_CUT)) for name in DENSE]
    star = cfgs[-1][1]
    cfgs.append((f"starcoder2-7b/w{DENSE_ROLLING_WINDOW}",
                 dataclasses.replace(star, sliding_window=DENSE_ROLLING_WINDOW)))
    return cfgs


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def phase_dense(dev):
    """The dense GQA family through ``models.lm``: the float32 check of
    granite-8b, minicpm-2b and starcoder2-7b at their published widths, then
    granite-8b's bfloat16 timings at full size.  Returns (results, launch
    counts of the window)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm

    b, s0, steps = DENSE_CHECK
    prompt_gen = torch.Generator().manual_seed(1)
    LAUNCHES.clear()  # the dense path's window starts here
    checks, name = [], None
    for label, cfg in _dense_check_configs():
        t0 = time.perf_counter()
        n_ln = 2 * cfg.n_layers + 1
        per_call = {"prefill": {"flash_attention": cfg.n_layers, "layernorm": n_ln},
                    "decode": {"flash_attention": 0, "layernorm": n_ln}}
        if cfg.name != name:  # the windowed starcoder2-7b keeps its weights
            name = cfg.name
            params_cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
            params = _to(params_cpu, dev)
        prompt = torch.randint(0, cfg.vocab_size, (b, s0), generator=prompt_gen)
        check = _greedy_check(label, cfg, params, params_cpu, prompt, steps,
                              _launch_checker(label, per_call), DENSE_TOL)
        check.update(model=label, d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
                     head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff, n_layers=cfg.n_layers,
                     window=cfg.sliding_window, launches_per_call=per_call,
                     seconds=time.perf_counter() - t0)
        checks.append(check)
        log(f"[dense] float32 check {label}: {cfg.n_layers} layers d {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
            f"window {cfg.sliding_window}; {b} x {s0} prompt + {steps} greedy steps  "
            f"|card - cpu| {check['max_abs_err_vs_cpu']:.2e}  |decode - forward({s0 + steps})| "
            f"{check['max_abs_err_decode_vs_forward']:.2e} (tol {DENSE_TOL})  tokens differ at "
            f"{check['greedy_differs_at_close_calls'] or 'no step'}  launches/call {per_call}  "
            f"({check['seconds']:.1f} s)")
    del params, params_cpu

    # bfloat16 timings: granite-8b at its published widths, drawn on the card
    torch.cuda.empty_cache()
    base = dataclasses.replace(get_config("granite-8b"), n_layers=GRANITE_TIME_LAYERS)
    n_ln = 2 * base.n_layers + 1
    checked = _launch_checker("granite-8b bf16", {
        "prefill": {"flash_attention": base.n_layers, "layernorm": n_ln},
        "decode": {"flash_attention": 0, "layernorm": n_ln}})
    params = lm.init_params(base, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    weight_bytes = _nbytes(params)
    t_gen = torch.Generator(device=dev).manual_seed(2)
    timings = []
    for bt in GRANITE_TIME_BATCHES:
        t0 = time.perf_counter()
        max_len = GRANITE_TIME_LEN + GRANITE_TIME_STEPS
        caches = lm.init_caches(base, bt, max_len, device=dev)
        tk = torch.randint(0, base.vocab_size, (bt, GRANITE_TIME_LEN), generator=t_gen, device=dev)

        def prefill():
            return lm.prefill(params, base, {"tokens": tk}, caches, device=dev)

        torch.cuda.reset_peak_memory_stats()
        last, filled = checked("prefill", prefill)
        if not torch.isfinite(last.float()).all():
            raise SmokeError(f"granite-8b bf16 prefill b{bt}: non-finite logits")
        ms = median_ms(prefill, 5 if bt > 1 else 10, warmup=2)
        prof = profile_forward(prefill, iters=3)
        timings.append(dict(kind="prefill", batch=bt, tokens=GRANITE_TIME_LEN, median_ms=ms,
                            tokens_per_s=bt * GRANITE_TIME_LEN / (ms * 1e-3), profile=prof,
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        start_tok = last.argmax(-1, keepdim=True)
        del last

        def decode_run(steps=GRANITE_TIME_STEPS):
            tok, c = start_tok, filled
            for k in range(steps):
                pos = torch.full((bt,), GRANITE_TIME_LEN + k, dtype=torch.int32, device=dev)
                lg, c = lm.decode_step(params, base, tok, pos, c, device=dev)
                tok = lg.argmax(-1, keepdim=True)
            return tok

        def one_step():
            return lm.decode_step(params, base, start_tok,
                                  torch.full((bt,), GRANITE_TIME_LEN, device=dev), filled,
                                  device=dev)

        checked("decode", one_step)
        torch.cuda.reset_peak_memory_stats()
        run_ms = median_ms(decode_run, 3, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        dprof = profile_forward(lambda: decode_run(GRANITE_PROFILE_STEPS), iters=1)
        dprof["device_ms_per_step"] = dprof.get("device_ms_per_fwd", 0.0) / GRANITE_PROFILE_STEPS
        timings.append(dict(kind="decode", batch=bt, steps=GRANITE_TIME_STEPS,
                            cache_len=max_len, ms_per_token=run_ms / GRANITE_TIME_STEPS,
                            tokens_per_s=bt * GRANITE_TIME_STEPS / (run_ms * 1e-3),
                            profile=dprof, device_ops_per_step=_device_ops(one_step),
                            cache_bytes_copied_per_step=_nbytes(filled), peak_gb=peak,
                            seconds=time.perf_counter() - t0))
        del filled, caches
    for t in timings:
        prof, busy = t["profile"], t["profile"]["busy_share"]
        what = (f"prefill {t['batch']} x {t['tokens']}  median {t['median_ms']:.3f} ms"
                if t["kind"] == "prefill" else
                f"decode batch {t['batch']}  {t['ms_per_token']:.3f} ms/token, "
                f"{t['device_ops_per_step']} device ops/step, cache copy "
                f"{t['cache_bytes_copied_per_step'] / 1e9:.3f} GB/step")
        per, key = (("step", "device_ms_per_step") if t["kind"] == "decode"
                    else ("call", "device_ms_per_fwd"))
        dev_t = ("" if busy is None else f"  device ms/{per} {prof[key]:.3f}, attention share "
                 f"{prof['attention_share']:.1%}, layernorm share {prof['layernorm_share']:.1%}")
        if "seconds" in t:
            dev_t += f"  ({t['seconds']:.1f} s with the prefill)"
        log(f"[dense] granite-8b bf16 {base.n_layers} layers {what}  {t['tokens_per_s']:.1f} "
            f"tokens/s  peak {t['peak_gb']:.1f} GB  device busy "
            f"{'not measured' if busy is None else f'{busy:.1%}'}{dev_t}  top {prof['top']}")
    del params
    torch.cuda.empty_cache()
    counts = dict(LAUNCHES)  # the dense path's window ends here
    for kname in ("flash_attention", "layernorm"):
        if counts.get(kname, 0) <= 0:
            raise SmokeError(f"{kname} was never launched on the dense LM path")
    log(f"[dense] dense LM path launches: {counts}")
    return dict(check=checks, granite_8b=dict(n_layers=base.n_layers, d_model=base.d_model,
                                               weight_bytes=weight_bytes, timings=timings)), counts


# ---------------------------------------------------------------- phase 7 --


def _serve_prompts(seed, lengths, shared, n_shared, vocab):
    """Prompts of the given lengths from a seed; the first ``n_shared`` start
    with one common prefix of ``shared`` tokens (prefix-cache traffic)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pre = torch.randint(0, vocab, (shared,), generator=g).tolist()
    out = []
    for i, n in enumerate(lengths):
        body = torch.randint(0, vocab, (n,), generator=g).tolist()
        out.append(pre + body[:n - shared] if i < n_shared else body)
    return out


def _direct_greedy(cfg, params, prompt, steps, dev, quantized=False, kernel=None):
    """Greedy tokens of ``lm.prefill`` / ``decode_step`` at batch 1 (float32
    caches of prompt + steps, or the int8 caches with ``quantized``) and each
    step's top-two logit margin; ``kernel`` reaches both (MLA's
    ``mla_absorb``)."""
    import torch

    from repro_torch.models import lm

    caches = lm.init_caches(cfg, 1, len(prompt) + steps, torch.float32, quantized=quantized,
                            device=dev)
    last, caches = lm.prefill(params, cfg, {"tokens": torch.tensor([prompt], device=dev)},
                              caches, kernel=kernel, device=dev)
    toks, margins = [], []
    for k in range(steps):
        top2 = last[0].float().topk(2).values
        margins.append(float(top2[0] - top2[1]))
        tok = last.argmax(-1, keepdim=True)
        toks.append(int(tok))
        pos = torch.full((1,), len(prompt) + k, dtype=torch.int32, device=dev)
        last, caches = lm.decode_step(params, cfg, tok, pos, caches, kernel=kernel, device=dev)
    return toks, margins


def _held_to(label, streams, ref, margins, tol):
    """Each stream equals ``ref`` (the CPU direct loop), or leaves it at a
    step where the CPU's top-two margin is under ``tol``; returns the close
    calls."""
    close = []
    for name, got in streams.items():
        for i, (s, r, m) in enumerate(zip(got, ref, margins)):
            if len(s) != len(r):
                raise SmokeError(f"{label} {name} request {i}: {len(s)} tokens, expected {len(r)}")
            k = next((k for k in range(len(r)) if s[k] != r[k]), None)
            if k is None:
                continue
            if m[k] >= tol:
                raise SmokeError(f"{label} {name} request {i} leaves the CPU direct loop at "
                                 f"step {k} (margin {m[k]:.2e} >= {tol})")
            close.append(dict(stream=name, request=i, step=k, cpu_margin=m[k]))
    return close


def _run_engine(eng, prompts, max_new):
    """Submit every prompt, stream every request to its end; returns the
    token streams and the engine-side metrics (TTFT and ITL from
    ``TokenEvent.ts``)."""
    handles = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    t0 = time.perf_counter()
    events = [list(eng.stream(h)) for h in handles]
    wall = time.perf_counter() - t0
    streams = [[ev.token for ev in evs] for evs in events]
    ttft = [evs[0].ts - eng.request(h).created_at for h, evs in zip(handles, events)]
    itl = [(evs[-1].ts - evs[0].ts) / (len(evs) - 1) for evs in events if len(evs) > 1]
    n_tok = sum(len(s) for s in streams)
    q = statistics.quantiles
    return streams, dict(
        requests=len(prompts), tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
        ttft_ms_p50=statistics.median(ttft) * 1e3, ttft_ms_p95=q(ttft, n=20)[-1] * 1e3,
        itl_ms_p50=statistics.median(itl) * 1e3 if itl else None)


def _count_decodes(executor, fn):
    """Run ``fn`` and return (its result, the executor's decode dispatches
    in it, each of decode_steps steps).  The counting wrapper is removed
    again: it refers back to the executor, and the cycle would keep the
    executor's caches alive after the engine is dropped."""
    calls = [0]
    scan = executor._decode_scan

    def counted(*a, **k):
        calls[0] += 1
        return scan(*a, **k)

    executor._decode_scan = counted
    try:
        return fn(), calls[0]
    finally:
        del executor._decode_scan


def _decode_profile(eng, prompts):
    """Fill every slot with a long request, then profile one pure decode
    dispatch (``Engine.step``): device-busy share, device operations per
    decode step, and the paged gather's (``paged_decode_view``'s
    ``index_select``) share of the dispatch's device time, measured in
    place (alone, the gather's writes would drain from L2 after it ends)."""
    import torch

    sc = eng.serve_cfg
    handles = [eng.submit(p, max_new_tokens=8 * sc.decode_steps)
               for p in prompts[:sc.max_batch]]
    while len(eng.scheduler.queue) or not all(s.active for s in eng.executor.slots):
        eng.step()
    torch.cuda.synchronize()
    prof = profile_forward(eng.step, iters=1)  # its warm-up call is the first pure decode
    ops = prof.get("device_ops_per_fwd", float("nan")) / sc.decode_steps
    dev_ms = prof.get("device_ms_per_fwd")
    share = prof.get("gather_share")
    for h in handles:  # free the slots (decoding the rest would only cost time)
        eng.cancel(h)
    return dict(busy_share=prof["busy_share"], device_ms_per_dispatch=dev_ms,
                device_ms_per_step=None if dev_ms is None else dev_ms / sc.decode_steps,
                device_ops_per_step=ops, top=prof["top"], gather_share=share,
                gather_ms_per_layer=(None if share is None else share * dev_ms
                                     / (eng.executor.cfg.n_layers * sc.decode_steps)))


def phase_serve(dev):
    """The serving engine (``serve.api.Engine``) on the card: (a) the
    float32 check of granite-8b and mamba2-130m at their published widths,
    2 layers, against the port's CPU engine and a direct ``lm`` greedy loop;
    (b) granite-8b bf16 at 5 layers under the dense, paged and paged +
    prefix-cache layouts; (c) mamba2-130m bf16 at full depth.  Returns
    (results, launch counts of the window)."""
    import torch

    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.serve.api import Engine

    LAUNCHES.clear()  # the serving path's window starts here
    # (a) float32 check
    checks = []
    for name, layouts, lengths in SERVE_CHECK:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(name), **DENSE_CUT)
        params_cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        params = _to(params_cpu, dev)
        prompts = _serve_prompts(3, lengths, 32, len(lengths) // 2, cfg.vocab_size)
        steps = SERVE_CHECK_NEW
        ref, margins = zip(*(_direct_greedy(cfg, params_cpu, p, steps, "cpu") for p in prompts))
        streams = {"direct loop on the card":
                   [_direct_greedy(cfg, params, p, steps, dev)[0] for p in prompts]}
        streams["cpu engine"], _ = _run_engine(
            Engine(cfg, params_cpu, ServeConfig(**SERVE_CHECK_SC), device="cpu"), prompts, steps)
        for layout in layouts:
            sc = ServeConfig(**SERVE_CHECK_SC, **layout)
            label = f"{name} {sc.kv_layout}{' + prefix cache' if sc.kv_prefix_cache else ''}"
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # prefill-skip needs bit-exact
                eng = Engine(cfg, params, sc, device=dev)
            streams[f"card engine, {label}"], _ = _run_engine(eng, prompts, steps)
            checks.append(dict(model=name, layout=label,
                               disabled_features=eng.telemetry["disabled_features"]))
        close = _held_to(f"[serve] {name}", streams, ref, margins, DENSE_TOL)
        for c in checks[-len(layouts):]:
            c.update(requests=len(prompts), new_tokens=steps, close_calls=close, tol=DENSE_TOL,
                     min_cpu_margin=min(min(m) for m in margins))
        log(f"[serve] float32 check {name}: {cfg.n_layers} layers d {cfg.d_model}, "
            f"{len(prompts)} requests x {steps} greedy tokens: {'; '.join(streams)} agree with "
            f"the CPU direct loop (close calls {close or 'none'}; disabled on the card: "
            f"{[c['disabled_features'] for c in checks[-len(layouts):]]}) "
            f"({time.perf_counter() - t0:.1f} s)")
        del params, params_cpu, eng

    # (b) granite-8b bf16, three layouts
    runs = _granite_serve_runs(dev)

    # (c) mamba2-130m bf16 at full depth: exact-length prefill, dense state
    mbase = get_config(MAMBA)
    mparams = lm.init_params(mbase, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    mprompts = _serve_prompts(6, MAMBA_SERVE_LEN, 0, 0, mbase.vocab_size)
    t0 = time.perf_counter()
    eng = Engine(mbase, mparams, ServeConfig(**MAMBA_SERVE_SC), device=dev)
    torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    (streams, metrics), decodes = _count_decodes(
        eng.executor, lambda: _run_engine(eng, mprompts, SERVE_NEW))
    tel = eng.telemetry
    grew = {k: LAUNCHES.get(k, 0) - before.get(k, 0) for k in ("ssd_scan", "layernorm")}
    m_ln = 2 * mbase.n_layers + 1
    want = {"ssd_scan": mbase.n_layers * tel["prefill_dispatches"],
            "layernorm": m_ln * (tel["prefill_dispatches"] + decodes * eng.serve_cfg.decode_steps)}
    if grew != want:
        raise SmokeError(f"[serve] mamba2-130m: launches {grew}, expected {want}")
    if any(len(s) != SERVE_NEW for s in streams):
        raise SmokeError("[serve] mamba2-130m: a request stopped short")
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _decode_profile(eng, mprompts)
    run = dict(model=MAMBA, n_layers=mbase.n_layers, layout=eng.executor.kv_layout, **metrics,
               prefill_dispatches=tel["prefill_dispatches"], decode_dispatches=decodes,
               prefill_compiles=tel["prefill_compiles"], decode_compiles=tel["decode_compiles"],
               launches=grew, peak_gb=peak, kv_bytes=tel["kv_bytes"], decode_profile=prof,
               seconds=time.perf_counter() - t0)
    runs.append(run)
    log(_serve_line(run))
    del eng, mparams
    torch.cuda.empty_cache()
    counts = dict(LAUNCHES)  # the serving path's window ends here
    for kname in ("flash_attention", "layernorm", "ssd_scan"):
        if counts.get(kname, 0) <= 0:
            raise SmokeError(f"{kname} was never launched on the serving path")
    log(f"[serve] serving path launches: {counts}")
    return dict(check=checks, runs=runs), counts


def _granite_serve_runs(dev, layouts=SERVE_LAYOUTS) -> list[dict]:
    """Phase 7b: granite-8b bf16 at ``GRANITE_SERVE_LAYERS`` of its 36 layers
    (the script's time limit) under float, phase 7's traffic through the
    engine in each of ``layouts``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    torch.cuda.empty_cache()
    base = dataclasses.replace(get_config("granite-8b"), n_layers=GRANITE_SERVE_LAYERS)
    params = lm.init_params(base, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    runs = _serve_layouts(base, params, _serve_traffic(base), layouts, dev, "[serve]")
    del params
    torch.cuda.empty_cache()
    return runs


def _serve_traffic(cfg):
    """Phase 7's 16 requests: 64-1536 tokens from a seed, the first 8 sharing
    a 512-token prefix."""
    import torch

    g = torch.Generator().manual_seed(4)
    lengths = torch.randint(SERVE_LEN[0], SERVE_LEN[1] + 1, (SERVE_REQUESTS,), generator=g)
    lengths = [max(int(n), SERVE_SHARED + 64) if i < SERVE_SHARED_REQUESTS else int(n)
               for i, n in enumerate(lengths)]
    return _serve_prompts(5, lengths, SERVE_SHARED, SERVE_SHARED_REQUESTS, cfg.vocab_size)


def _launches_per_call(cfg) -> dict:
    """The kernel launches of one prefill (or train forward) and of one
    decode step of ``cfg`` through ``models.lm``.  Attention blocks:
    ``flash_attention`` once per layer per prefill, never in decode;
    ``layernorm`` for ln1 and ln2 (MLA: and q_norm, kv_norm) per layer, plus
    the final norm, in both.  The ssm and hybrid families: ``ssd_scan`` once
    per Mamba2 layer per prefill, never in decode; the hybrid's shared block
    ``flash_attention`` once per application per prefill; ``layernorm`` ln1
    and the gate norm per Mamba2 layer, ln1 and ln2 per application, plus
    the final norm."""
    from repro_torch.models import lm

    if cfg.family in ("ssm", "hybrid"):
        apps = lm.n_shared_apps(cfg)
        n_ln = 2 * cfg.n_layers + 2 * apps + 1
        return {"prefill": {"ssd_scan": cfg.n_layers, "flash_attention": apps, "layernorm": n_ln},
                "decode": {"ssd_scan": 0, "flash_attention": 0, "layernorm": n_ln}}
    n_ln = (4 if cfg.attn_kind == "mla" else 2) * cfg.n_layers + 1
    return {"prefill": {"flash_attention": cfg.n_layers, "layernorm": n_ln},
            "decode": {"flash_attention": 0, "layernorm": n_ln}}


def _checked_engine_run(eng, prompts, max_new, label):
    """``_run_engine`` with its checks: each kernel's launches per prefill
    dispatch and decode step (``_launches_per_call``: none of attention or
    the SSD scan in decode), and the program budget: ``len(buckets) + 2``
    with bucketed prefill; with the exact-length prefill of the ssm and
    hybrid families, one program per distinct prompt length and one decode
    program, as the reference compiles them.  Returns (streams, metrics,
    decode dispatches, launches, budget)."""
    from repro_torch.kernels import LAUNCHES

    cfg, sc = eng.executor.cfg, eng.serve_cfg
    per = _launches_per_call(cfg)
    before = dict(LAUNCHES)
    (streams, metrics), decodes = _count_decodes(
        eng.executor, lambda: _run_engine(eng, prompts, max_new))
    grew = {k: LAUNCHES.get(k, 0) - before.get(k, 0) for k in per["prefill"]}
    tel = eng.telemetry
    steps_run = decodes * sc.decode_steps
    want = {k: per["prefill"][k] * tel["prefill_dispatches"] + per["decode"][k] * steps_run
            for k in per["prefill"]}
    if grew != want:
        raise SmokeError(f"{label}: launches {grew}, expected {want} ({tel['prefill_dispatches']} "
                         f"prefill dispatches, {steps_run} decode steps)")
    budget = (len(eng.executor.buckets) + 2 if eng.executor.bucketable
              else len({len(p) for p in prompts}) + 1)
    if tel["prefill_compiles"] + tel["decode_compiles"] > budget:
        raise SmokeError(f"{label}: {tel['prefill_compiles']} prefill + "
                         f"{tel['decode_compiles']} decode shapes > budget {budget}")
    return streams, metrics, decodes, grew, budget


def _serve_layouts(base, params, prompts, layouts, dev, tag, policy=None, profile=True,
                   shared_may_differ=False, kernel=None, keep_streams=False,
                   sc_kw=SERVE_SC) -> list[dict]:
    """``prompts`` x ``SERVE_NEW`` tokens through one ``Engine`` per layout
    (``sc_kw``, ``policy`` or the model's own, ``kernel`` knobs): the same
    tokens under every layout (a layout the family cannot take falls back to
    dense), the launches of ``_checked_engine_run`` per prefill dispatch and
    decode step, the program budget; then, with ``profile``,
    one decode dispatch profiled (``profile="first"``: under the first
    layout only).  ``shared_may_differ``: under the prefix
    cache, the requests that share the prefix (the first
    ``SERVE_SHARED_REQUESTS``) may differ from the first layout's; they are
    recorded.  Returns a record per layout (with its token streams under
    ``keep_streams``)."""
    import torch

    from repro_torch.configs import ServeConfig
    from repro_torch.serve.api import Engine

    runs, first = [], None
    for layout in layouts:
        t0 = time.perf_counter()
        sc = ServeConfig(**sc_kw, **layout, policy=policy)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            eng = Engine(base, params, sc, kernel=kernel, device=dev)
        torch.cuda.reset_peak_memory_stats()
        label = f"{sc.kv_layout}{' + prefix cache' if sc.kv_prefix_cache else ''}"
        if eng.executor.kv_layout != sc.kv_layout:
            label += f" (falls back to {eng.executor.kv_layout})"
        streams, metrics, decodes, grew, budget = _checked_engine_run(
            eng, prompts, SERVE_NEW, f"{tag} {base.name} {label}")
        tel = eng.telemetry
        if any(len(s) != SERVE_NEW for s in streams):
            raise SmokeError(f"{tag} {base.name} {label}: a request stopped short")
        bad = [] if first is None else [i for i, (a, b) in enumerate(zip(streams, first))
                                        if a != b]
        first = first or streams
        allowed = (range(SERVE_SHARED_REQUESTS) if shared_may_differ and sc.kv_prefix_cache
                   else ())
        if any(i not in allowed for i in bad):
            raise SmokeError(f"{tag} {base.name} {label}: token streams differ from the "
                             f"{layouts[0] or 'dense'} run at requests {bad}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = (_decode_profile(eng, prompts)
                if profile is True or (profile == "first" and not runs) else None)
        run = dict(model=base.name, n_layers=base.n_layers, layout=label,
                   policy=eng.executor.policy.name, **metrics,
                   prefill_dispatches=tel["prefill_dispatches"], decode_dispatches=decodes,
                   prefill_compiles=tel["prefill_compiles"],
                   decode_compiles=tel["decode_compiles"], budget=budget,
                   prefix_hits=tel["prefix_hits"],
                   prefix_tokens_shared=tel["prefix_tokens_shared"],
                   disabled_features=tel["disabled_features"], launches=grew, peak_gb=peak,
                   kv_bytes=tel["kv_bytes"], decode_profile=prof, differ_from_first=bad,
                   seconds=time.perf_counter() - t0)
        if keep_streams:
            run["streams"] = streams
        runs.append(run)
        log(_serve_line(run, tag) + (f"  requests differing from the first layout's: {bad}"
                                     if bad else ""))
        del eng
        torch.cuda.empty_cache()
    return runs


def _serve_line(r, tag="[serve]") -> str:
    p = r["decode_profile"] or dict(busy_share=None, device_ops_per_step=float("nan"),
                                    gather_share=None, top="not profiled")
    busy = ("not measured" if p["busy_share"] is None else
            f"{p['busy_share']:.1%}, {p['device_ms_per_step']:.2f} device ms/step")
    gather = ("" if p["gather_share"] is None else
              f", row gathers (the paged view) {p['gather_ms_per_layer']:.4f} ms/layer = "
              f"{p['gather_share']:.1%} of decode device time")
    itl = "n/a" if r["itl_ms_p50"] is None else f"{r['itl_ms_p50']:.2f}"
    policy = f" {r['policy']}" if "policy" in r else ""
    return (f"{tag} {r['model']} bf16{policy} {r['n_layers']} layers, {r['layout']}: "
            f"{r['requests']} "
            f"requests, {r['tokens']} tokens in {r['wall_s']:.2f} s = {r['tokens_per_s']:.1f} "
            f"output tokens/s  TTFT p50 {r['ttft_ms_p50']:.1f} / p95 {r['ttft_ms_p95']:.1f} ms  "
            f"ITL p50 {itl} ms  {r['prefill_dispatches']} prefill + {r['decode_dispatches']} "
            f"decode dispatches, {r['prefill_compiles']} + {r['decode_compiles']} shapes  "
            f"launches {r['launches']}  peak {r['peak_gb']:.1f} GB  KV {r['kv_bytes'] / 1e9:.3f} "
            f"GB  decode dispatch: device "
            f"busy {busy}, {p['device_ops_per_step']:.0f} device ops/step{gather}  "
            f"top {p['top']}  ({r['seconds']:.1f} s)")


# ---------------------------------------------------------------- phase 9 --


def _record_routes(fn):
    """Run ``fn`` with ``models.moe.route`` recording each call's (probs,
    expert ids) on the host; returns (fn's result, the records)."""
    from repro_torch.models import moe

    real, records = moe.route, []

    def recorded(params, cfg, flat, **kw):
        out = real(params, cfg, flat, **kw)
        records.append((out[1].float().cpu(), out[2].cpu()))
        return out

    moe.route = recorded
    try:
        return fn(), records
    finally:
        moe.route = real


def _codes_and_routes(cfg, params, params_cpu, dev) -> dict:
    """One prefill (``lm.forward``) of ``INT8_CODES`` seeded tokens into int8
    caches on the card and on the CPU (the plan's int8 weights on both): the
    share of int8 KV codes (k / v, or MLA's latent) that differ (each by at
    most 1) and, for MoE
    configs, the share of router decisions that flip (each where the CPU's
    k-th and (k+1)-th probabilities lie within ``ROUTER_TIE``) and the
    dropped shares of both."""
    import torch

    from repro_torch.models import lm

    b, n = INT8_CODES
    toks = torch.randint(0, cfg.vocab_size, (b, n), generator=torch.Generator().manual_seed(7))
    out = {}
    for where, p in (("card", params), ("cpu", params_cpu)):
        caches = lm.init_caches(cfg, b, n, torch.float32, quantized=True,
                                device="cpu" if where == "cpu" else dev)
        (_, filled, aux), routes = _record_routes(lambda: lm.forward(
            p, cfg, {"tokens": toks}, mode="prefill", caches=caches,
            device=next(iter(caches["layers"].values())).device))
        out[where] = ({k: t.cpu() for k, t in filled["layers"].items() if t.dtype == torch.int8},
                      routes, float(aux.get("moe_dropped_frac", 0.0)))
    (codes, routes, dropped), (codes_cpu, routes_cpu, dropped_cpu) = out["card"], out["cpu"]
    diff = torch.cat([(codes[k].int() - codes_cpu[k].int()).abs().reshape(-1) for k in codes])
    if int(diff.max()) > 1:
        raise SmokeError(f"[int8] {cfg.name}: KV codes differ by {int(diff.max())} > 1")
    rec = dict(kv_codes=int(diff.numel()), kv_codes_differ_share=float((diff > 0).float().mean()))
    if cfg.moe is not None:
        k, flips, decisions = cfg.moe.top_k, 0, 0
        for (_, ids), (p_cpu, ids_cpu) in zip(routes, routes_cpu):
            moved = (ids.sort(-1).values != ids_cpu.sort(-1).values).any(-1)
            top = p_cpu.sort(-1, descending=True).values
            gap = top[:, k - 1] - top[:, k]
            if bool((moved & (gap >= ROUTER_TIE)).any()):
                raise SmokeError(f"[int8] {cfg.name}: a router decision flips where the CPU's "
                                 f"k-th / (k+1)-th gap is {float(gap[moved].max()):.2e} "
                                 f">= {ROUTER_TIE}")
            flips += int(moved.sum())
            decisions += moved.numel()
        if len(routes) != cfg.n_layers or decisions == 0:
            raise SmokeError(f"[int8] {cfg.name}: {len(routes)} router calls in the prefill")
        if flips == 0 and dropped != dropped_cpu:
            raise SmokeError(f"[int8] {cfg.name}: dropped share {dropped} on the card, "
                             f"{dropped_cpu} on the CPU, with the same routes")
        rec.update(router_decisions=decisions, router_flip_share=flips / decisions,
                   capacity_factor=cfg.moe.capacity_factor, dropped_share=dropped,
                   dropped_share_cpu=dropped_cpu)
    return rec


def _policy_check(dev, cfg, lengths, steps, tag, loops=None, codes_cfg=None,
                  extra=None) -> dict:
    """The float32 check of one model under its policy (phases 9a and 10a):
    the card's engines (dense, paged) and a direct ``lm`` loop on the card
    per entry of ``loops`` (label: kernel dict), each equal to the port's CPU
    direct loop but where its top-two margin is under ``DENSE_TOL``; the
    port's CPU engine too; under an int8 KV cache, then the codes (and
    routes) of one prefill of ``codes_cfg`` (default ``cfg``).
    ``extra(params)``, given the card's weights under the plan, returns more
    of the record."""
    import torch

    from repro_torch.configs import ServeConfig
    from repro_torch.core import precision
    from repro_torch.models import lm
    from repro_torch.serve.api import Engine

    t0 = time.perf_counter()
    # the int8 KV cache of the plan, where the family takes one (the
    # executor's rule: never the ssm or hybrid state)
    quantized = (precision.resolve_model_plan(cfg).int8_kv_cache
                 and cfg.family not in ("ssm", "hybrid"))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompts = _serve_prompts(3, lengths, 32, len(lengths) // 2, cfg.vocab_size)
    sc = dict(SERVE_CHECK_SC, policy=cfg.precision)
    # the CPU engine first, from a host copy of the weights; its executor's
    # weights (the plan's transform) then feed the CPU direct loop
    eng = Engine(cfg, _to(params, "cpu"), ServeConfig(**sc), device="cpu")
    streams = {"cpu engine": _run_engine(eng, prompts, steps)[0]}
    params_cpu = eng.executor.params
    del eng
    ref, margins = zip(*(_direct_greedy(cfg, params_cpu, p, steps, "cpu", quantized)
                         for p in prompts))
    params_q, launches = None, {}
    for layout in INT8_LAYOUTS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # prefill-skip needs bit-exact
            eng = Engine(cfg, params, ServeConfig(**sc, **layout), device=dev)
        label = eng.executor.kv_layout
        if layout and label == "dense":  # a layout the family cannot take: dense, same tokens
            label = f"dense (asked {layout['kv_layout']})"
        got, _, _, grew, _ = _checked_engine_run(eng, prompts, steps,
                                                 f"{tag} {cfg.name} {cfg.precision} {label}")
        if "asked" in label and got != streams["card engine, dense"]:
            raise SmokeError(f"{tag} {cfg.name}: the {label} engine's tokens differ from dense")
        streams[f"card engine, {label}"] = got
        launches[label] = grew
        if params_q is None:
            params_q = eng.executor.params  # the card's weights under the plan
        del eng
    for label, kernel in (loops or {"direct loop on the card": None}).items():
        streams[label] = [_direct_greedy(cfg, params_q, p, steps, dev, quantized, kernel)[0]
                          for p in prompts]
    close = _held_to(f"{tag} {cfg.name}", streams, ref, margins, DENSE_TOL)
    rec = dict(model=cfg.name, policy=cfg.precision, n_layers=cfg.n_layers,
               d_model=cfg.d_model, requests=len(prompts), new_tokens=steps, close_calls=close,
               tol=DENSE_TOL, min_cpu_margin=min(min(m) for m in margins), launches=launches)
    codes = ""
    if quantized:
        rec.update(_codes_and_routes(codes_cfg or cfg, params_q, params_cpu, dev))
        codes = (f"; KV codes card vs CPU differ in {rec['kv_codes_differ_share']:.4%} of "
                 f"{rec['kv_codes']} (each by <= 1)")
    if extra is not None:
        rec.update(extra(params_q))
    del params, params_q, params_cpu
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    log(f"{tag} float32 check {cfg.name} {cfg.precision}: {cfg.n_layers} layers d "
        f"{cfg.d_model}, {len(prompts)} requests x {steps} greedy tokens: {'; '.join(streams)} "
        f"agree with the CPU direct loop (close calls {close or 'none'}){codes}; launches "
        f"{launches} ({rec['seconds']:.1f} s)")
    return rec


def _int8_check(dev, name, n_layers, lengths, steps) -> dict:
    """Phase 9a for one model under int8_serve (``_policy_check``).  A MoE
    config runs at capacity factor e / k, so that no token is dropped and a
    token's output is its own; its codes and routes are taken at the
    published capacity factor."""
    from repro_torch.configs import get_config

    published = dataclasses.replace(get_config(name), n_layers=n_layers, vocab_size=512,
                                    dtype="float32", precision="int8_serve")
    cfg = published
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    rec = _policy_check(dev, cfg, lengths, steps, "[int8]", codes_cfg=published)
    if cfg.moe is not None:
        log(f"[int8] {name}: checked at capacity factor {cfg.moe.capacity_factor:g}; at the "
            f"published {published.moe.capacity_factor:g} router decisions flipped "
            f"{rec['router_flip_share']:.4%} of {rec['router_decisions']}, dropped "
            f"{rec['dropped_share']:.4%} (CPU {rec['dropped_share_cpu']:.4%})")
    return rec


def _moe_split_ms(cfg, ffn, t, dev) -> tuple[float | None, float]:
    """Device ms of one MoE layer (``moe_apply``, profiler) over ``t`` tokens
    in the weights' dtype, and ms of its expert GEMMs alone (``moe.experts``
    on the (e, capacity, d) batches; CUDA events over back-to-back calls:
    the profiler's sums for these three ``bmm``s came back below the
    bandwidth and FLOP floors in some runs); the rest is routing, dispatch
    and combine."""
    import torch

    from repro_torch.models import moe

    g = torch.Generator(device=dev).manual_seed(8)
    dt = ffn["w_up"].dtype
    x = torch.randn(1, t, cfg.d_model, generator=g, device=dev).to(dt)
    xin = torch.randn(cfg.moe.n_experts, moe.capacity(cfg, t), cfg.d_model, generator=g,
                      device=dev).to(dt)
    return (device_ms(lambda: moe.moe_apply(ffn, cfg, x), 10),
            time_ms(lambda: moe.experts(ffn, cfg, xin), 20))


def phase_int8_moe(dev, float_runs=None):
    """int8_serve and the MoE family: (a) the float32 check of granite-8b,
    granite-moe-3b-a800m (2 layers) and dbrx-132b (1 layer) under int8_serve;
    (b) granite-moe-3b-a800m bf16 at 8 layers through the engine, three
    layouts; (c) its ``lm.prefill`` at 1 and 8 x 2048; (d) granite-8b bf16 at
    5 layers under int8_serve, dense and paged, beside ``float_runs`` (phase
    7's).  Returns (results, launch counts of the window)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import precision
    from repro_torch.core.latency_model import H100
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.models.params import map_leaves

    LAUNCHES.clear()  # the int8_serve / MoE path's window starts here
    checks = [_int8_check(dev, *c) for c in INT8_CHECK]

    # (b) granite-moe-3b-a800m bf16, 4 of its 32 layers (the script's time
    # limit), its own serve_policy
    torch.cuda.empty_cache()
    base = dataclasses.replace(get_config(MOE_SERVE), n_layers=MOE_SERVE_LAYERS)
    params = lm.init_params(base, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompts = _serve_traffic(base)
    # at the published capacity factor an expert drops what overflows its
    # capacity, so a token's hidden state, and a prompt's KV, depend on the
    # tokens batched with it: a prefix-cache hit reads the KV its first
    # tenant computed in another batch, and those requests may differ from
    # the dense run.  Without drops (capacity factor e / k) every request
    # must agree across the layouts.
    runs = _serve_layouts(base, params, prompts, SERVE_LAYOUTS, dev, "[int8]",
                          policy=base.serve_policy, shared_may_differ=True)
    nodrop = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=base.moe.n_experts / base.moe.top_k))
    nodrop_runs = _serve_layouts(nodrop, params, prompts, SERVE_LAYOUTS[::2], dev,
                                 f"[int8] capacity factor {nodrop.moe.capacity_factor:g}:",
                                 policy=base.serve_policy, profile=False)
    qcfg = dataclasses.replace(base, precision=base.serve_policy)
    params_q = precision.apply_plan_to_params(params, precision.resolve_model_plan(qcfg))
    layer0 = map_leaves(lambda _, t: t[0], params_q["blocks"]["ffn"])
    weight_bytes = _nbytes(params)
    decode_floor = weight_bytes / H100.hbm_bw * 1e3
    moe_ms, gemm_ms = _moe_split_ms(base, layer0, SERVE_SC["max_batch"], dev)
    for r in runs:
        step = r["decode_profile"]["device_ms_per_step"]
        r.update(decode_floor_ms=decode_floor, moe_layer_device_ms=moe_ms,
                 expert_gemm_device_ms=gemm_ms)
        if step and moe_ms is not None and gemm_ms is not None:
            r["moe_dispatch_combine_share"] = base.n_layers * (moe_ms - gemm_ms) / step
            r["expert_gemm_share"] = base.n_layers * gemm_ms / step
        log(f"[int8] {base.name} decode step: {step if step is None else round(step, 3)} device "
            f"ms (floor {decode_floor:.2f} ms: {weight_bytes / 1e9:.2f} GB of weights at 3.35 "
            f"TB/s); one MoE layer at {SERVE_SC['max_batch']} tokens {moe_ms} ms, its expert "
            f"GEMMs {gemm_ms} ms: routing, dispatch and combine "
            f"{r.get('moe_dispatch_combine_share', float('nan')):.1%}, expert GEMMs "
            f"{r.get('expert_gemm_share', float('nan')):.1%} of the step ({r['layout']})")

    # (c) lm.prefill at 1 and 8 x 2048: as served (int8 weights, int8 caches,
    # the LUT softmax through the float32 route) and under float (bf16 caches)
    n_ln = 2 * base.n_layers + 1
    checked = _launch_checker(f"{base.name} prefill", {
        "prefill": {"flash_attention": base.n_layers, "layernorm": n_ln}})
    prefills = []
    t_gen = torch.Generator(device=dev).manual_seed(2)
    for policy, p in ((base.serve_policy, params_q), ("float", params)):
        pcfg = dataclasses.replace(base, precision=policy)
        quantized = precision.resolve_model_plan(pcfg).int8_kv_cache
        for bt in MOE_PREFILL_BATCHES:
            t0 = time.perf_counter()
            caches = lm.init_caches(pcfg, bt, MOE_PREFILL_LEN, torch.float32 if quantized
                                    else torch.bfloat16, quantized=quantized, device=dev)
            tk = torch.randint(0, base.vocab_size, (bt, MOE_PREFILL_LEN), generator=t_gen,
                               device=dev)

            def prefill():
                return lm.prefill(p, pcfg, {"tokens": tk}, caches, device=dev)

            torch.cuda.reset_peak_memory_stats()
            last, _ = checked("prefill", prefill)
            if not torch.isfinite(last.float()).all():
                raise SmokeError(f"{base.name} {policy} prefill b{bt}: non-finite logits")
            del last
            ms = median_ms(prefill, 5, warmup=1)
            prof = profile_forward(prefill, iters=2)
            moe_ms, gemm_ms = _moe_split_ms(
                base, map_leaves(lambda _, t: t[0], p["blocks"]["ffn"]), bt * MOE_PREFILL_LEN, dev)
            tflop, floor_ms, floor_by = _prefill_floor(pcfg, bt, MOE_PREFILL_LEN)
            dev_ms = prof.get("device_ms_per_fwd")
            rec = dict(policy=policy, batch=bt, tokens=MOE_PREFILL_LEN, median_ms=ms,
                       tokens_per_s=bt * MOE_PREFILL_LEN / (ms * 1e-3), profile=prof,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9, tflop=tflop,
                       floor_ms=floor_ms, floor_by=floor_by, moe_layer_device_ms=moe_ms,
                       expert_gemm_device_ms=gemm_ms, seconds=time.perf_counter() - t0)
            if dev_ms and gemm_ms is not None and moe_ms is not None:
                rec["expert_gemm_share"] = base.n_layers * gemm_ms / dev_ms
                rec["moe_dispatch_combine_share"] = base.n_layers * (moe_ms - gemm_ms) / dev_ms
            prefills.append(rec)
            busy = prof["busy_share"]
            log(f"[int8] {base.name} lm.prefill {bt} x {MOE_PREFILL_LEN} bf16 {policy}: median "
                f"{ms:.2f} ms ({rec['tokens_per_s']:.0f} tokens/s; floor {floor_ms:.2f} ms by "
                f"{floor_by}, {tflop:.1f} TFLOP), device ms "
                f"{'not measured' if dev_ms is None else f'{dev_ms:.2f}'}, busy "
                f"{'not measured' if busy is None else f'{busy:.1%}'}, expert GEMMs "
                f"{rec.get('expert_gemm_share', float('nan')):.1%}, routing / dispatch / combine "
                f"{rec.get('moe_dispatch_combine_share', float('nan')):.1%}, attention "
                f"{prof.get('attention_share', float('nan')):.1%}, peak {rec['peak_gb']:.1f} GB  "
                f"top {prof['top']}")
            del caches
    del params, params_q, layer0
    torch.cuda.empty_cache()

    # (d) granite-8b bf16, 5 layers as phase 7b, int8_serve, dense and paged
    g8 = dataclasses.replace(get_config("granite-8b"), n_layers=GRANITE_SERVE_LAYERS)
    params = lm.init_params(g8, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    g8_runs = _serve_layouts(g8, params, _serve_traffic(g8), SERVE_LAYOUTS[:2], dev, "[int8]",
                             policy="int8_serve")
    del params
    torch.cuda.empty_cache()
    for r in g8_runs:
        f = next((x for x in float_runs or () if x["model"] == g8.name
                  and x["layout"] == r["layout"]), None)
        r["float_run"] = None if f is None else {
            k: f[k] for k in ("itl_ms_p50", "tokens_per_s", "kv_bytes")} | {
            "device_ms_per_step": f["decode_profile"]["device_ms_per_step"]}
        log(f"[int8] granite-8b {r['layout']}: int8_serve ITL p50 {r['itl_ms_p50']:.2f} ms, "
            f"{r['decode_profile']['device_ms_per_step']} device ms/step, KV "
            f"{r['kv_bytes'] / 1e9:.3f} GB; float (phase 7, this build): " + (
                "not run" if f is None else
                f"ITL p50 {f['itl_ms_p50']:.2f} ms, {f['decode_profile']['device_ms_per_step']} "
                f"device ms/step, KV {f['kv_bytes'] / 1e9:.3f} GB"))
    counts = dict(LAUNCHES)  # the int8_serve / MoE path's window ends here
    for kname in ("flash_attention", "layernorm"):
        if counts.get(kname, 0) <= 0:
            raise SmokeError(f"{kname} was never launched on the int8_serve / MoE path")
    log(f"[int8] int8_serve / MoE path launches: {counts}")
    return dict(check=checks, moe_runs=runs, moe_nodrop_runs=nodrop_runs, moe_prefill=prefills,
                granite_8b_runs=g8_runs, moe_weight_bytes=weight_bytes), counts


# --------------------------------------------------------------- phase 10 --


def _mla_absorb_diff(cfg, params, dev, quantized) -> float:
    """Max |logits| difference of one decode step after a 2 x 64 prefill,
    absorbed against materialized, on ``dev``."""
    import torch

    from repro_torch.models import lm

    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=torch.Generator().manual_seed(9))
    toks = toks.to(dev)
    pos = torch.full((2,), 64, dtype=torch.int32, device=dev)
    outs = []
    for absorb in (False, True):
        kernel = {"mla_absorb": absorb}
        caches = lm.init_caches(cfg, 2, 65, torch.float32, quantized, device=dev)
        _, caches = lm.prefill(params, cfg, {"tokens": toks[:, :64]}, caches, kernel=kernel,
                               device=dev)
        last, _ = lm.decode_step(params, cfg, toks[:, 64:], pos, caches, kernel=kernel,
                                 device=dev)
        outs.append(last.float())
    return float((outs[0] - outs[1]).abs().max())


def _mla_check(dev, policy) -> dict:
    """Phase 10a under one policy (``_policy_check``): minicpm3-4b at its
    published widths, 2 layers, vocab 512, float32, with direct loops on the
    card for the materialized and the absorbed decode; then the absorbed
    decode's logits within ``MLA_ABSORB_TOL`` of the materialized ones on the
    card, and under int8_serve the latent codes card vs CPU differing in at
    most ``MLA_CODES_SHARE``."""
    from repro_torch.configs import get_config
    from repro_torch.core import precision

    cfg = dataclasses.replace(get_config(MLA), **DENSE_CUT, precision=policy)
    quantized = precision.resolve_model_plan(cfg).int8_kv_cache
    loops = {f"direct loop on the card, {'absorbed' if a else 'materialized'}": {"mla_absorb": a}
             for a in (False, True)}
    rec = _policy_check(dev, cfg, MLA_CHECK_LENGTHS, SERVE_CHECK_NEW, "[mla]", loops=loops,
                        extra=lambda p: {"absorb_max_abs_diff":
                                         _mla_absorb_diff(cfg, p, dev, quantized)})
    diff = rec["absorb_max_abs_diff"]
    if not diff <= MLA_ABSORB_TOL:
        raise SmokeError(f"[mla] {policy}: absorbed decode logits differ from the materialized "
                         f"ones by {diff:.2e} > {MLA_ABSORB_TOL}")
    if quantized and rec["kv_codes_differ_share"] > MLA_CODES_SHARE:
        raise SmokeError(f"[mla] {policy}: latent codes card vs CPU differ in "
                         f"{rec['kv_codes_differ_share']:.4%} > {MLA_CODES_SHARE:.1%}")
    log(f"[mla] {policy}: absorbed vs materialized logits {diff:.2e} (<= {MLA_ABSORB_TOL})")
    return rec


def phase_mla(dev):
    """MLA, minicpm3-4b: (a) the float32 check under float and int8_serve;
    (b) bf16 at 12 of its 62 layers under int8_serve through the engine, three
    layouts, then dense with the absorbed decode; (c) ``lm.prefill`` at 1 and
    8 x 2048 under int8_serve and float.  Returns (results, launch counts of
    the window)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import precision
    from repro_torch.core.latency_model import H100
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm

    LAUNCHES.clear()  # the MLA path's window starts here
    checks = [_mla_check(dev, policy) for policy in ("float", "int8_serve")]

    # (b) bf16, MLA_SERVE_LAYERS of its 62 layers, its own serve_policy (int8_serve)
    torch.cuda.empty_cache()
    base = dataclasses.replace(get_config(MLA), n_layers=MLA_SERVE_LAYERS)
    params = lm.init_params(base, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    weight_bytes = _nbytes(params)
    prompts = _serve_traffic(base)
    # one decode dispatch profiled under the dense layout (the paged ones add
    # the gather, 0.3 % of decode device time in this PR's first chip call):
    # each profile costs ~20 s of the phase's budget
    runs = _serve_layouts(base, params, prompts, SERVE_LAYOUTS, dev, "[mla]",
                          policy=base.serve_policy, profile="first", keep_streams=True)
    absorbed = _serve_layouts(base, params, prompts, SERVE_LAYOUTS[:1], dev,
                              "[mla] absorbed decode:", policy=base.serve_policy,
                              kernel={"mla_absorb": True}, keep_streams=True)[0]
    m, b, length = base.mla, SERVE_SC["max_batch"], SERVE_SC["max_seq_len"]
    # the materialized decode's floor: K and V of every slot's whole latent
    # view re-projected per layer and step, in float32 off the tensor cores
    materialize_tflop = (2.0 * b * length * m.kv_lora_rank * base.n_heads
                         * (m.qk_nope_head_dim + m.v_head_dim) * base.n_layers / 1e12)
    materialize_floor = materialize_tflop * 1e12 / H100.peak_for("float32") * 1e3
    tokens_per_slot = base.n_layers * b * length
    latent_f32 = tokens_per_slot * (m.kv_lora_rank + m.qk_rope_head_dim) * 4
    gqa_f32 = tokens_per_slot * 2 * base.n_heads * m.v_head_dim * 4
    dense = runs[0]
    pairs = [(x, y) for s, t in zip(dense["streams"], absorbed["streams"]) for x, y in zip(s, t)]
    absorbed["equal_token_share"] = sum(x == y for x, y in pairs) / len(pairs)
    absorbed["requests_identical"] = sum(s == t for s, t in zip(dense["streams"],
                                                                absorbed["streams"]))
    for r in runs + [absorbed]:
        step = (r["decode_profile"] or {}).get("device_ms_per_step")
        r.update(materialize_tflop_per_step=materialize_tflop,
                 materialize_floor_ms=materialize_floor, latent_f32_bytes=latent_f32,
                 gqa_f32_bytes=gqa_f32)
        log(f"[mla] {base.name} {r['layout']}{' absorbed' if r is absorbed else ''}: decode "
            f"{'not profiled' if step is None else round(step, 3)} device ms/step "
            f"(materialization floor "
            f"{materialize_floor:.2f} ms: {materialize_tflop:.2f} TFLOP in float32 at 67 "
            f"TFLOP/s); latent cache {r['kv_bytes'] / 1e9:.3f} GB = "
            f"{r['kv_bytes'] / latent_f32:.1%} of float32 latents ({latent_f32 / 1e9:.3f} GB), "
            f"{r['kv_bytes'] / gqa_f32:.2%} of a float32 40 x 64 GQA cache "
            f"({gqa_f32 / 1e9:.2f} GB)")
    log(f"[mla] absorbed decode, dense: ITL p50 {absorbed['itl_ms_p50']:.2f} ms (materialized "
        f"{dense['itl_ms_p50']:.2f}), {absorbed['equal_token_share']:.1%} of tokens and "
        f"{absorbed['requests_identical']} of {len(prompts)} requests equal to the "
        f"materialized run's")
    for r in runs + [absorbed]:
        del r["streams"]

    # (c) lm.prefill at 1 and 8 x 2048: as served (int8 weights, the int8
    # latent, the LUT softmax through the float32 route) and under float
    n_ln = 4 * base.n_layers + 1
    checked = _launch_checker(f"{base.name} prefill", {
        "prefill": {"flash_attention": base.n_layers, "layernorm": n_ln}})
    qcfg = dataclasses.replace(base, precision=base.serve_policy)
    params_q = precision.apply_plan_to_params(params, precision.resolve_model_plan(qcfg))
    prefills = []
    t_gen = torch.Generator(device=dev).manual_seed(2)
    for policy, p in ((base.serve_policy, params_q), ("float", params)):
        pcfg = dataclasses.replace(base, precision=policy)
        quantized = precision.resolve_model_plan(pcfg).int8_kv_cache
        for bt in MLA_PREFILL_BATCHES:
            t0 = time.perf_counter()
            caches = lm.init_caches(pcfg, bt, MLA_PREFILL_LEN, torch.float32 if quantized
                                    else torch.bfloat16, quantized=quantized, device=dev)
            tk = torch.randint(0, base.vocab_size, (bt, MLA_PREFILL_LEN), generator=t_gen,
                               device=dev)

            def prefill():
                return lm.prefill(p, pcfg, {"tokens": tk}, caches, device=dev)

            torch.cuda.reset_peak_memory_stats()
            last, _ = checked("prefill", prefill)
            if not torch.isfinite(last.float()).all():
                raise SmokeError(f"{base.name} {policy} prefill b{bt}: non-finite logits")
            del last  # the checked call was the warm-up
            ms = median_ms(prefill, 3, warmup=0)
            prof = profile_forward(prefill, iters=1)
            # the attend runs at q/k 96, V 64 natively: no pad copy around it
            prof["pad_ops"] = pad_ops(prefill) if bt == MLA_PREFILL_BATCHES[0] else None
            if prof["pad_ops"]:
                raise SmokeError(f"{base.name} {policy} prefill pads: {prof['pad_ops']}")
            tflop, floor_ms, floor_by = _prefill_floor(pcfg, bt, MLA_PREFILL_LEN)
            dev_ms = prof.get("device_ms_per_fwd")
            rec = dict(policy=policy, batch=bt, tokens=MLA_PREFILL_LEN, median_ms=ms,
                       tokens_per_s=bt * MLA_PREFILL_LEN / (ms * 1e-3), profile=prof,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9, tflop=tflop,
                       floor_ms=floor_ms, floor_by=floor_by, seconds=time.perf_counter() - t0)
            prefills.append(rec)
            busy = prof["busy_share"]
            log(f"[mla] {base.name} lm.prefill {bt} x {MLA_PREFILL_LEN} bf16 {policy}: median "
                f"{ms:.2f} ms ({rec['tokens_per_s']:.0f} tokens/s; floor {floor_ms:.2f} ms by "
                f"{floor_by}, {tflop:.1f} TFLOP), device ms "
                f"{'not measured' if dev_ms is None else f'{dev_ms:.2f}'}, busy "
                f"{'not measured' if busy is None else f'{busy:.1%}'}, attention "
                f"{prof.get('attention_share', float('nan')):.1%}, layernorm "
                f"{prof.get('layernorm_share', float('nan')):.1%}, peak {rec['peak_gb']:.1f} GB, "
                f"pad ops {'not traced' if prof['pad_ops'] is None else prof['pad_ops']}  "
                f"top {prof['top']}")
            del caches
    del params, params_q
    torch.cuda.empty_cache()
    counts = dict(LAUNCHES)  # the MLA path's window ends here
    for kname in ("flash_attention", "layernorm"):
        if counts.get(kname, 0) <= 0:
            raise SmokeError(f"{kname} was never launched on the MLA path")
    log(f"[mla] MLA path launches: {counts}")
    return dict(check=checks, runs=runs, absorbed_run=absorbed, prefill=prefills,
                weight_bytes=weight_bytes), counts


# --------------------------------------------------------------- phase 11 --


def _families_kernel_cases(dev) -> list[dict]:
    """The kernel cases of phase 11's path: zamba2-1.2b's shared block
    attends (8, 32 / 32, 2048, 128) causal (bf16 safe and LUT, and the
    float32 LUT route) and its 38 Mamba2 layers scan (8, 2048, 64 heads of
    P 64, N 64, chunk 64); hubert-xlarge attends (8, 16, 512, 80) both ways
    (head_dim 80 padded to 128); internvl2-1b (8, 14 / 2, 512, 64) causal
    (bf16, and its int8 KV cache's float32 LUT route); rows that see no key
    (a window of 256 ending before kv_len 640) on the head_dim 8-32, (64, 64)
    and (128, 128) routes; the norms: RMSNorm over 2048 and 4096 (zamba2's
    blocks and its shared block), LayerNorm over 1280 (hubert), RMSNorm over
    896 (internvl2), bf16."""
    b, l = FAMILY_ATTENTION_ROWS
    cases = [_attention_case(dev, (b, 32, l, 128), mode, causal=True, dtype=dtype,
                             sdpa_yardstick=True)
             for dtype, mode in (("bfloat16", "safe"), ("bfloat16", "lut"), ("float32", "lut"))]
    cases += [_ssd_case(dev, b, l, 64, 64, 64, 1, 64, dtype=dtype)
              for dtype in ("float32", "bfloat16")]
    for mode in ("safe", "lut"):
        cases.append(_attention_case(dev, (8, 16, AUDIO_FRAMES, 80), mode, dtype="bfloat16",
                                     sdpa_yardstick=True))
        cases.append(_attention_case(dev, (8, 14, 2 * VLM_TEXT, 64), mode, causal=True,
                                     dtype="bfloat16", hkv=2, sdpa_yardstick=True))
    cases.append(_attention_case(dev, (8, 14, 2 * VLM_TEXT, 64), "lut", causal=True,
                                 dtype="float32", hkv=2, sdpa_yardstick=True))
    for d in (16, 64, 128):
        cases.append(_attention_case(dev, (2, 8, 1000, d), "safe", causal=True, window=256,
                                     kv_len=640))
    cases += [_layernorm_case(dev, b * l, k, True, False, "bfloat16") for k in (2048, 4096)]
    cases.append(_layernorm_case(dev, 8 * AUDIO_FRAMES, 1280, False, False, "bfloat16"))
    cases.append(_layernorm_case(dev, 8 * 2 * VLM_TEXT, 896, True, False, "bfloat16"))
    return cases


def _pad_share(fn) -> dict:
    """The device time of the attention wrapper's pad copies (its profiler
    scope ``PAD_SCOPE``: q, k, v zero-padded, the output's slice copied)
    within one call of ``fn``, from a trace of the host's operators and the
    device: ms and share of the call's device time (None when the trace has
    no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention.ops import PAD_SCOPE

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def dev_us(e, total):
        return getattr(e, "device_time_total" if total else "self_device_time_total", None) \
            or getattr(e, "cuda_time_total" if total else "self_cuda_time_total", 0.0)

    events = prof.key_averages()
    busy = sum(dev_us(e, False) for e in events if e.device_type == cuda)
    pad = sum(dev_us(e, True) for e in events if e.key == PAD_SCOPE and e.device_type == cpu)
    scopes = sum(e.count for e in events if e.key == PAD_SCOPE and e.device_type == cpu)
    if busy <= 0:
        return dict(pad_ms=None, pad_share=None, pad_scopes=scopes)
    return dict(pad_ms=pad / 1e3, pad_share=pad / busy, pad_scopes=scopes,
                traced_device_ms=busy / 1e3)


def _hybrid_serve(dev) -> list[dict]:
    """Phase 11b: zamba2-1.2b bf16 at HYBRID_SERVE_LAYERS through the engine,
    under its serve_policy (int8_serve) and float, dense and paged (which
    falls back to dense with the same tokens): 16 exact-length requests of
    64-512 tokens x 32 new tokens; TTFT, ITL, tokens/s, one decode dispatch
    profiled per policy, the Mamba2 state's and the shared K/V's bytes."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import kv_cache

    torch.cuda.empty_cache()
    base = dataclasses.replace(get_config(HYBRID), n_layers=HYBRID_SERVE_LAYERS)
    params = lm.init_params(base, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompts = _serve_prompts(6, HYBRID_SERVE_LEN, 0, 0, base.vocab_size)
    spec = kv_cache.abstract_caches(base, HYBRID_SERVE_SC["max_batch"],
                                    HYBRID_SERVE_SC["max_seq_len"], torch.float32)
    group_bytes = {g: sum(int(np.prod(shape)) * 4 for shape, _ in leaves.values())
                   for g, leaves in spec.items()}
    runs = []
    for policy in (base.serve_policy, "float"):
        runs += _serve_layouts(base, params, prompts, HYBRID_LAYOUTS, dev, "[families]",
                               policy=policy, profile="first", sc_kw=HYBRID_SERVE_SC)
    for r in runs:
        r.update(state_bytes=group_bytes["layers"], shared_kv_bytes=group_bytes["shared"])
        if r["kv_bytes"] != sum(group_bytes.values()):
            raise SmokeError(f"[families] {HYBRID}: KV bytes {r['kv_bytes']}, expected "
                             f"{group_bytes}")
    log(f"[families] {HYBRID} caches (float32, {HYBRID_SERVE_SC['max_batch']} slots x "
        f"{HYBRID_SERVE_SC['max_seq_len']}): Mamba2 state {group_bytes['layers'] / 1e6:.1f} MB "
        f"over {base.n_layers} layers, shared K/V {group_bytes['shared'] / 1e9:.3f} GB over "
        f"{spec['shared']['k'][0][0]} applications")
    del params
    torch.cuda.empty_cache()
    return runs


def _frontend_timings(dev) -> list[dict]:
    """Phase 11c: hubert-xlarge (16 of 48 layers) ``lm.forward`` on 1 and 8 x 512
    frames, and internvl2-1b (8 of 24 layers) ``lm.prefill`` of 1 and 8 x (256
    image + 256 text) tokens then 32 greedy ``decode_step``s, bf16, under
    float and under their serve_policy (int8_serve): median ms, device ms,
    busy share, attention share, and hubert's pad copies' share."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import precision
    from repro_torch.models import lm

    out = []
    gen = torch.Generator(device=dev).manual_seed(3)
    for name in (AUDIO, VLM):
        torch.cuda.empty_cache()
        base = dataclasses.replace(get_config(name), n_layers=FRONTEND_TIME_LAYERS[name])
        params = lm.init_params(base, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        checked = _launch_checker(name, _launches_per_call(base))
        for policy in ("float", base.serve_policy):
            pcfg = dataclasses.replace(base, precision=policy)
            plan = precision.resolve_model_plan(pcfg)
            p = params if policy == "float" else precision.apply_plan_to_params(params, plan)
            quantized = plan.int8_kv_cache
            for bt in FRONTEND_BATCHES:
                t0 = time.perf_counter()
                if name == AUDIO:
                    frames = torch.randn(bt, AUDIO_FRAMES, base.frontend_dim, generator=gen,
                                         device=dev, dtype=torch.bfloat16)

                    def run():
                        return lm.forward(p, pcfg, {"frames": frames}, device=dev)[0]

                    what = f"forward {bt} x {AUDIO_FRAMES} frames"
                else:
                    patches = torch.randn(bt, base.n_frontend_tokens, base.frontend_dim,
                                          generator=gen, device=dev, dtype=torch.bfloat16)
                    tokens = torch.randint(0, base.vocab_size, (bt, VLM_TEXT), generator=gen,
                                           device=dev)
                    n_img = base.n_frontend_tokens
                    caches = lm.init_caches(pcfg, bt, n_img + VLM_TEXT + VLM_DECODE_STEPS,
                                            torch.float32 if quantized else torch.bfloat16,
                                            quantized=quantized, device=dev)

                    def run():
                        return lm.prefill(p, pcfg, {"patches": patches, "tokens": tokens},
                                          caches, device=dev)

                    what = f"prefill {bt} x ({n_img} image + {VLM_TEXT} text)"
                torch.cuda.reset_peak_memory_stats()
                res = checked("prefill", run)
                logits = res if name == AUDIO else res[0]
                if not torch.isfinite(logits.float()).all():
                    raise SmokeError(f"[families] {name} {policy} {what}: non-finite logits")
                ms = median_ms(run, 5 if bt > 1 else 10, warmup=1)
                prof = profile_forward(run, iters=3)
                rec = dict(model=name, policy=policy, batch=bt, what=what, median_ms=ms,
                           profile=prof, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
                if name == AUDIO:
                    rec.update(frames_per_s=bt * AUDIO_FRAMES / (ms * 1e-3), **_pad_share(run))
                else:
                    rec["tokens_per_s"] = bt * (n_img + VLM_TEXT) / (ms * 1e-3)
                    filled, start = res[1], res[0].argmax(-1, keepdim=True)

                    def decode_run():
                        tok, c = start, filled
                        for k in range(VLM_DECODE_STEPS):
                            pos = torch.full((bt,), n_img + VLM_TEXT + k, dtype=torch.int32,
                                             device=dev)
                            lg, c = lm.decode_step(p, pcfg, tok, pos, c, device=dev)
                            tok = lg.argmax(-1, keepdim=True)
                        return tok

                    checked("decode", lambda: lm.decode_step(
                        p, pcfg, start, torch.full((bt,), n_img + VLM_TEXT, device=dev), filled,
                        device=dev))
                    run_ms = median_ms(decode_run, 3, warmup=0)  # warm: the checked step
                    rec.update(decode_ms_per_token=run_ms / VLM_DECODE_STEPS,
                               decode_tokens_per_s=bt * VLM_DECODE_STEPS / (run_ms * 1e-3))
                    del caches, filled
                rec["seconds"] = time.perf_counter() - t0
                out.append(rec)
                busy, dev_ms = prof["busy_share"], prof.get("device_ms_per_fwd")
                extra = (f", pad copies {rec['pad_ms']:.3f} ms = {rec['pad_share']:.1%} of device "
                         f"time ({rec['pad_scopes']} scopes)" if rec.get("pad_share") is not None
                         else "" if name != AUDIO else ", pad copies not measured")
                if name == VLM:
                    extra = (f"; decode {rec['decode_ms_per_token']:.3f} ms/token "
                             f"({rec['decode_tokens_per_s']:.0f} tokens/s)")
                log(f"[families] {name} {base.n_layers} L bf16 {policy} {what}: median "
                    f"{ms:.3f} ms, device ms "
                    f"{'not measured' if dev_ms is None else f'{dev_ms:.3f}'}, busy "
                    f"{'not measured' if busy is None else f'{busy:.1%}'}, attention "
                    f"{prof.get('attention_share', float('nan')):.1%}, layernorm "
                    f"{prof.get('layernorm_share', float('nan')):.1%}{extra}, peak "
                    f"{rec['peak_gb']:.1f} GB  top {prof['top']}")
            del p
        del params
    torch.cuda.empty_cache()
    return out


def phase_families(dev):
    """The hybrid family and the modality frontends: (a) float32 checks at
    the published widths and reduced depth: zamba2-1.2b at 7 layers through
    the engine (dense, and paged, which falls back to dense) against the
    port's CPU engine and direct loops; hubert-xlarge at 2 layers, the card's
    logits against the CPU's; internvl2-1b at 2 layers, 256 patches and text
    then greedy decode against the CPU path; (b) zamba2-1.2b bf16 at 13
    layers through the engine under int8_serve and float; (c) hubert-xlarge
    and internvl2-1b bf16 at a third of their depth.  Returns (results, launch counts of
    the window)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm

    LAUNCHES.clear()  # the families path's window starts here
    cut = dict(vocab_size=512, dtype="float32")
    # (a) zamba2-1.2b at 7 layers: the shared block at layers 0 and 6
    zcfg = dataclasses.replace(get_config(HYBRID), n_layers=HYBRID_CHECK_LAYERS, **cut,
                               precision="float")
    checks = [_policy_check(dev, zcfg, HYBRID_CHECK_LENGTHS, SERVE_CHECK_NEW, "[families]")]
    # hubert-xlarge at 2 layers: the card's logits against the CPU's
    t0 = time.perf_counter()
    acfg = dataclasses.replace(get_config(AUDIO), n_layers=FRONTEND_CHECK_LAYERS,
                               dtype="float32")
    params_cpu = lm.init_params(acfg, torch.Generator().manual_seed(SEED), device="cpu")
    b, s = AUDIO_CHECK
    frames = torch.randn(b, s, acfg.frontend_dim, generator=torch.Generator().manual_seed(1))
    checked = _launch_checker(AUDIO, {"prefill": _launches_per_call(acfg)["prefill"]})
    card = checked("prefill", lambda: lm.forward(_to(params_cpu, dev), acfg,
                                                 {"frames": frames.to(dev)}, device=dev)[0])
    ref = lm.forward(params_cpu, acfg, {"frames": frames}, device="cpu")[0]
    real = ref[..., :acfg.vocab_size]
    err = float((card.cpu()[..., :acfg.vocab_size] - real).abs().max())
    if not (err <= AUDIO_TOL and torch.isfinite(card).all()):
        raise SmokeError(f"[families] {AUDIO} float32: |card - cpu| {err:.3e} > {AUDIO_TOL}")
    checks.append(dict(model=AUDIO, n_layers=acfg.n_layers, batch=b, frames=s,
                       max_abs_err_vs_cpu=err, tol=AUDIO_TOL, max_abs_logit=float(real.abs().max()),
                       seconds=time.perf_counter() - t0))
    log(f"[families] float32 check {AUDIO}: {acfg.n_layers} layers d {acfg.d_model}, {b} x {s} "
        f"frames, |card - cpu| {err:.2e} (tol {AUDIO_TOL}; logits up to "
        f"{checks[-1]['max_abs_logit']:.2f}) ({checks[-1]['seconds']:.1f} s)")
    del params_cpu, card
    # internvl2-1b at 2 layers: 256 patches + text, greedy decode
    t0 = time.perf_counter()
    vcfg = dataclasses.replace(get_config(VLM), n_layers=FRONTEND_CHECK_LAYERS, **cut)
    params_cpu = lm.init_params(vcfg, torch.Generator().manual_seed(SEED), device="cpu")
    b, s, steps = VLM_CHECK
    g = torch.Generator().manual_seed(2)
    patches = torch.randn(b, vcfg.n_frontend_tokens, vcfg.frontend_dim, generator=g)
    prompt = torch.randint(0, vcfg.vocab_size, (b, s), generator=g)
    check = _greedy_check(VLM, vcfg, _to(params_cpu, dev), params_cpu, prompt, steps,
                          _launch_checker(VLM, _launches_per_call(vcfg)), DENSE_TOL,
                          patches=patches)
    check.update(model=VLM, n_layers=vcfg.n_layers, seconds=time.perf_counter() - t0)
    checks.append(check)
    log(f"[families] float32 check {VLM}: {vcfg.n_layers} layers d {vcfg.d_model}, {b} x "
        f"({vcfg.n_frontend_tokens} patches + {s}) prompt + {steps} greedy steps  |card - cpu| "
        f"{check['max_abs_err_vs_cpu']:.2e}  |decode - forward| "
        f"{check['max_abs_err_decode_vs_forward']:.2e} (tol {DENSE_TOL})  tokens differ at "
        f"{check['greedy_differs_at_close_calls'] or 'no step'} ({check['seconds']:.1f} s)")
    del params_cpu
    torch.cuda.empty_cache()

    runs = _hybrid_serve(dev)  # (b)
    timings = _frontend_timings(dev)  # (c)
    counts = dict(LAUNCHES)  # the families path's window ends here
    for kname in ("flash_attention", "layernorm", "ssd_scan"):
        if counts.get(kname, 0) <= 0:
            raise SmokeError(f"{kname} was never launched on the families path")
    log(f"[families] families path launches: {counts}")
    return dict(check=checks, runs=runs, timings=timings), counts


# ---------------------------------------------------------------- phase 8 --

# Training (phase 8).  (a) Each autograd.Function (the kernel forward, a
# backward in torch ops) against torch autograd through the plain version on
# the card, at the encoders' attention shapes (batch 1024), granite-like GQA
# (2, 32 q / 8 kv, 256, 128) causal in float32 and bf16, and a window with
# kv_len < L; the norms at the encoders' and granite's widths.  safe: 2e-5
# of the largest |grad| (the two backwards sum the same float32 terms in
# other orders); bf16: 3e-2 of it (the inputs' rounding).  lut: dQ = dK = 0
# exactly, dV within 1e-4 of max(1, max |dV|), plus on under 1 % of its rows
# one exp-table step of P^T |dO| (the two recompute the scores with
# differently shaped products, which may move a table entry at a tie).
# Norms: 1e-5 of max(1, max |grad|); with the LUT, rows whose variance sits at
# a 1/sqrt-table tie may move by one table step (0.3 %), on under 1 % of rows.
TRAIN_ATT_CASES = (  # (b, h, l, d), kv heads, causal, window, kv_len, dtype, V head_dim
    ((1024, 4, 100, 8), 4, False, None, None, "float32", None),  # gw
    ((1024, 8, 15, 8), 8, False, None, None, "float32", None),  # btagging
    ((1024, 2, 50, 8), 2, False, None, None, "float32", None),  # engine_anomaly
    ((2, 32, 256, 128), 8, True, None, None, "float32", None),
    ((2, 32, 256, 128), 8, True, None, None, "bfloat16", None),
    ((2, 8, 256, 64), 2, True, 64, 200, "float32", None),
    ((2, 8, 256, 96), 8, True, None, None, "float32", 64),  # MLA's q/k 96, V 64
)
TRAIN_LN_CASES = (  # rows, width, RMSNorm, LUT
    (102400, 32, False, False), (102400, 32, False, True),  # gw
    (15360, 64, False, False), (15360, 64, False, True),  # btagging
    (4096, 4096, True, False), (4096, 4096, True, True),  # granite-8b (2 x 2048 tokens)
)
ATT_GRAD_REL = {"float32": 2e-5, "bfloat16": 3e-2}
LN_GRAD_REL = 1e-5
# (b) The physics workflow at Table I's widths (batch 1024, the example's
# seeded events).  The first 20 float steps of the port's CPU path, the card
# taking each step from the CPU's state: the loss within 1e-4, the
# parameters after the step within 1e-6 except where the card's and the
# CPU's gradients differ by more than 1e-4 of the CPU's (gradients at the
# float32 noise floor, which Adam's m / sqrt(v) follows).  Each step,
# not the two free-running runs: full-batch AdamW at lr 3e-3 amplifies a
# float32 rounding difference about 10x per step (the card's and the CPU's
# free-running losses part by 2e-4 by step 3 at gw), so after a few steps
# the runs differ by the trajectory, not by the arithmetic.  Then the whole
# workflow (150 float steps, PTQ, 60 QAT steps) against the JAX package's CPU
# run of the example's own ``train`` and ``auc_of`` from the same init (the
# port's, a torch generator seeded 0; the example itself draws JAX's
# PRNGKey(0), which torch cannot reproduce, and the init alone moves these
# AUCs by about 0.01).  The values come from
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tools/physics_workflow_reference.py
TRAIN_EVENTS, TRAIN_TRACK_STEPS, TRAIN_TRACK_TOL = 1024, 20, 1e-4
TRACK_PARAM_ATOL, TRACK_GRAD_NOISE = 1e-6, 1e-4
JAX_WORKFLOW = {  # (model, policy): (float AUC, PTQ AUC / float, QAT AUC / float)
    ("engine_anomaly", None): (0.9777763364719887, 1.0000312154922488, 0.9995103069653468),
    ("engine_anomaly", "paper_vu13p"): (0.9777763364719887, 1.0000312154922488,
                                        0.9919873733333854),
    ("btagging", None): (0.7679302502239224, 0.9989898577174965, 0.9962558911569414),
    ("btagging", "paper_vu13p"): (0.7679302502239224, 0.9989898577174965, 1.0001255825942832),
    ("gw", None): (0.9350401361270927, 0.998688191479161, 0.9927758725158773),
    ("gw", "paper_vu13p"): (0.9350401361270927, 0.998688191479161, 0.9973498611686317),
}
WORKFLOW_TOL = 0.02
# (c) An LM train step at granite-8b's published width cut to 1 layer (for
# the run's time limit: each checkpoint holds the float32 weights and both
# moments), float32, batch 2 x 2048 tokens:
# run_training for 8 steps with a checkpoint
# every 4, again killed at step 6 and resumed; both under
# torch.use_deterministic_algorithms(True), and the two runs' parameters
# must be bitwise equal.
LM_TRAIN_CUT = dict(n_layers=1, dtype="float32")
LM_TRAIN = dict(total_steps=8, checkpoint_every=4, warmup_steps=2, learning_rate=3e-4)
LM_TRAIN_SHAPE, LM_TRAIN_FAIL_AT = (2, 2048), 6
# (a) also SSDScan (the kernel forward, the plain scan's gradient recomputed
# in torch ops) against torch autograd through the plain ssd_chunked on the
# card, y's and the final state's cotangents both given, at mamba2-130m's
# (b, l, heads, P, N, groups) and zamba2-1.2b's widths, float32 and bf16:
# 1e-5 (float32) / 1e-2 (bf16) of max(1, max |grad|), the bounds of
# tests/test_torch_cuda_kernels.py's SSDScan cases.
TRAIN_SSD_CASES = ((2, 2048, 24, 64, 128, 1), (2, 2048, 64, 64, 64, 1))
SSD_GRAD_REL = {"float32": 1e-5, "bfloat16": 1e-2}
# (d) The Mamba2 and hybrid families trained through run_training, float32,
# batch 2 x 2048: mamba2-130m at all 24 layers, zamba2-1.2b at its published
# width cut to 7 of its 38 layers (two applications of the shared block),
# for the run's time limit.  (name, layers or None, steps, checkpoint every,
# step at which a second run is killed, then resumed: bitwise the straight
# run).  The run is replayed step by step on the card (its losses bitwise
# the run's), and the CPU path's loss from the card's parameters before each
# step (a forward) must be within SSM_TRAIN_TOL of the card's.
SSM_TRAIN = (("mamba2-130m", None, 3, 2, 2), ("zamba2-1.2b", 7, 2, 3, None))
SSM_TRAIN_SHAPE, SSM_TRAIN_TOL = (2, 2048), 1e-4
# (e) The sharded step (make_train_step(mesh=, rules=)) on a one-card mesh
# (NCCL, world size 1), mamba2-130m at full width in float32: two steps from
# the unsharded step's state, bitwise equal to it; the sharded state saved
# and restored onto the rules' shardings, bitwise.
MESH_TRAIN_STEPS = 2


def _attention_grad_case(dev, shape, hkv, causal, window, kv_len, dtype, mode, v_dim=None):
    import torch

    from repro_torch.kernels.flash_attention import mha, mha_ref

    b, h, l, d = shape
    dv = d if v_dim is None else v_dim
    g = torch.Generator().manual_seed(l * d + h + (kv_len or 0))
    tdt = getattr(torch, dtype)
    q, k, v = (torch.randn(b, hh, l, dd, generator=g).to(dev, tdt).requires_grad_()
               for hh, dd in ((h, d), (hkv, d), (hkv, dv)))
    dout = torch.randn(b, h, l, dv, generator=g).to(dev, tdt)
    kw = dict(causal=causal, window=window, mode=mode, kv_len=kv_len)
    out = mha(q, k, v, **kw)
    if "Attention" not in type(out.grad_fn).__name__:
        raise SmokeError(f"mha under grad did not go through the autograd.Function: "
                         f"{type(out.grad_fn).__name__}")
    grads = torch.autograd.grad(out, (q, k, v), dout)
    ref = torch.autograd.grad(mha_ref(q, k, v, **kw), (q, k, v), dout, allow_unused=True)
    ref = [torch.zeros_like(t) if r is None else r for t, r in zip((q, k, v), ref)]
    torch.cuda.synchronize()
    errs, ok = {}, True
    for name, gr, rf in zip(("dq", "dk", "dv"), grads, ref):
        scale = max(1.0, float(rf.float().abs().max()))
        if mode == "lut" and name != "dv":
            errs[name] = float(gr.float().abs().max())
            ok &= errs[name] == 0.0  # the table lookups carry no gradient: exactly 0
        elif mode == "lut":
            bound_dv = torch.autograd.grad(mha_ref(q, k, v, **kw), v, dout.abs())[0]  # P^T |dO|
            errs[name], rows_over, fine = close_enough(
                gr, rf, 1e-4 * scale, flip_allow=ATT_LUT_STEP * bound_dv.float())
            errs["dv_rows_over"] = rows_over
            ok &= fine
        else:
            errs[name], _, fine = close_enough(gr, rf, ATT_GRAD_REL[dtype] * scale)
            ok &= fine

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(q, k, v, **kw), (q, k, v), dout,
                                           allow_unused=True)

    iters = 5 if b * h * l * l > 1e8 else 10
    ms = time_ms(fwd_bwd(mha), iters)
    plain_ms = time_ms(fwd_bwd(mha_ref), iters)
    return dict(kernel="flash_attention", shape=list(shape), kv_heads=hkv, v_dim=dv,
                causal=causal, window=window, kv_len=kv_len, dtype=dtype, mode=mode,
                max_abs_err=errs, ok=bool(ok), fwd_bwd_ms=ms, plain_fwd_bwd_ms=plain_ms)


def _layernorm_grad_case(dev, rows, k, rms, use_lut):
    import torch

    from repro_torch.kernels.layernorm import layernorm, layernorm_ref

    g = torch.Generator().manual_seed(rows + k + use_lut)
    x = (torch.randn(rows, k, generator=g) * 3 + 0.5).to(dev).requires_grad_()
    gamma = (1 + 0.2 * torch.randn(k, generator=g)).to(dev).requires_grad_()
    beta = None if rms else torch.randn(k, generator=g).to(dev).requires_grad_()
    dout = torch.randn(rows, k, generator=g).to(dev)
    ins = [t for t in (x, gamma, beta) if t is not None]
    kw = dict(use_lut=use_lut, rms=rms, eps=1e-6 if rms else 1e-5)
    out = layernorm(x, gamma, beta, **kw)
    if "LayerNorm" not in type(out.grad_fn).__name__:
        raise SmokeError(f"layernorm under grad did not go through the autograd.Function: "
                         f"{type(out.grad_fn).__name__}")
    grads = torch.autograd.grad(out, ins, dout)
    ref = torch.autograd.grad(layernorm_ref(x, gamma, beta, **kw), ins, dout)
    torch.cuda.synchronize()
    errs, ok = {}, True
    for name, gr, rf in zip(("dx", "dgamma", "dbeta"), grads, ref):
        scale = max(1.0, float(rf.abs().max()))
        flip = LN_LUT_STEP * scale if use_lut and name == "dx" else None
        errs[name], _, fine = close_enough(gr if gr.ndim > 1 else gr[None],
                                           rf if rf.ndim > 1 else rf[None],
                                           LN_GRAD_REL * scale, flip_allow=flip)
        if use_lut and name != "dx":  # a moved row moves the column sums by its share
            fine = fine or errs[name] <= LN_LUT_STEP * scale
        ok &= fine

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(x, gamma, beta, **kw), ins, dout)

    return dict(kernel="layernorm", shape=[rows, k], mode=("rms" if rms else "ln")
                + ("+lut" if use_lut else ""), max_abs_err=errs, ok=bool(ok),
                fwd_bwd_ms=time_ms(fwd_bwd(layernorm), 10),
                plain_fwd_bwd_ms=time_ms(fwd_bwd(layernorm_ref), 10))


def _ssd_grad_case(dev, b, l, h, p, n, groups, dtype):
    import torch

    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_with_state

    g = torch.Generator().manual_seed(l + h + n)
    tdt = getattr(torch, dtype)
    x = [t.to(dev, tdt).requires_grad_() for t in (
        torch.randn(b, l, h, p, generator=g) * 0.5, -torch.randn(b, l, h, generator=g).abs() * 0.3,
        torch.randn(b, l, groups, n, generator=g) * 0.5,
        torch.randn(b, l, groups, n, generator=g) * 0.5)]
    dy = torch.randn(b, l, h, p, generator=g).to(dev, tdt)
    ds = torch.randn(b, h, p, n, generator=g).to(dev)

    def plain(*t):
        rep = h // groups
        y, s = ssd_chunked(t[0].float(), t[1].float(), t[2].float().repeat_interleave(rep, 2),
                           t[3].float().repeat_interleave(rep, 2), chunk=64)
        return y.to(tdt), s

    def kernel(*t):
        return ssd_with_state(*t, chunk=64)

    y, state = kernel(*x)
    if "SSDScan" not in type(y.grad_fn).__name__:
        raise SmokeError(f"ssd_with_state under grad did not go through the autograd.Function: "
                         f"{type(y.grad_fn).__name__}")
    grads = torch.autograd.grad((y, state), x, (dy, ds))
    ref = torch.autograd.grad(plain(*x), x, (dy, ds))
    torch.cuda.synchronize()
    errs, ok = {}, True
    for name, gr, rf in zip(("dxdt", "da", "dB", "dC"), grads, ref):
        scale = max(1.0, float(rf.float().abs().max()))
        errs[name], _, fine = close_enough(gr.float(), rf.float(), SSD_GRAD_REL[dtype] * scale)
        ok &= fine and bool(torch.isfinite(gr.float()).all())

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(*x), x, (dy, ds))

    return dict(kernel="ssd_scan", shape=[b, l, h, p, n], groups=groups, dtype=dtype,
                max_abs_err=errs, ok=bool(ok), fwd_bwd_ms=time_ms(fwd_bwd(kernel), 10),
                plain_fwd_bwd_ms=time_ms(fwd_bwd(plain), 10))


def _no_backward_raises(dev) -> list[str]:
    """The kernels without a backward refuse inputs that require grad."""
    import torch

    from repro_torch.kernels.lut_softmax import lut_softmax
    from repro_torch.kernels.qmatmul import qmatmul

    x = torch.randn(64, 32, device=dev, requires_grad=True)
    w = torch.randn(32, 32, device=dev)
    calls = {"lut_softmax": lambda: lut_softmax(x), "qmatmul": lambda: qmatmul(x, w)}
    raised = []
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "has no backward" not in str(e):
                raise
            raised.append(name)
            log(f"[grad] {name} under grad raises: {str(e)[:110]}...")
        else:
            raise SmokeError(f"{name} ran under grad: its output would drop the gradient")
    return raised


def _physics_step(cfg, x, y, params, dev):
    """One of the example's train steps (value_and_grad, then AdamW in
    place) as a callable, on copies of ``params``."""
    import torch

    from repro_torch.models import physics
    from repro_torch.models.params import map_leaves
    from repro_torch.optim import AdamW
    from repro_torch.train import value_and_grad

    params = map_leaves(lambda _, t: t.detach().to(dev, copy=True), params)
    opt = AdamW(schedule=lambda s: 3e-3, weight_decay=0.0)
    state = opt.init(params)
    batch = {"x": torch.tensor(x, device=dev), "y": torch.tensor(y, device=dev)}

    def step():
        (loss, _), grads = value_and_grad(physics.loss_fn, params, cfg, batch, device=dev)
        opt.update(grads, state, params)
        return loss

    return step


def _track_cpu_steps(cfg, x, y, init, dev) -> dict:
    """The example's first float training steps on the port's CPU path; at
    each, the card takes the same step from a copy of the CPU's parameters
    and AdamW state.  Held: each step's loss within TRAIN_TRACK_TOL, and the
    parameters after it within TRACK_PARAM_ATOL except where the two
    gradients differ by more than TRACK_GRAD_NOISE of the CPU's: an entry
    whose gradient is at the float32 noise floor (the key bias, for one, has
    an exactly zero gradient in exact arithmetic), where Adam's
    m / sqrt(v) follows the noise.  Where the gradients agree, Adam's update
    differs by at most that share of the learning rate."""
    import torch

    from repro_torch.models import physics
    from repro_torch.models.params import map_leaves
    from repro_torch.optim import AdamW
    from repro_torch.train import value_and_grad

    def copy(tree, device):
        return map_leaves(lambda _, t: t.detach().to(device, copy=True), tree)

    opt = AdamW(schedule=lambda s: 3e-3, weight_decay=0.0)
    params = copy(init, "cpu")
    state = opt.init(params)
    batches = {d: {"x": torch.tensor(x, device=d), "y": torch.tensor(y, device=d)}
               for d in ("cpu", dev)}
    out = {"cpu_losses": [], "loss_rel": [], "params_off": []}
    for _ in range(TRAIN_TRACK_STEPS):
        p_dev, s_dev = copy(params, dev), copy(state, dev)
        (l_dev, _), g_dev = value_and_grad(physics.loss_fn, p_dev, cfg, batches[dev], device=dev)
        opt.update(g_dev, s_dev, p_dev)
        (l_cpu, _), g_cpu = value_and_grad(physics.loss_fn, params, cfg, batches["cpu"],
                                           device="cpu")
        opt.update(g_cpu, state, params)
        out["cpu_losses"].append(float(l_cpu))
        out["loss_rel"].append(abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu)))
        off, unexplained, total = 0, 0, 0
        for (_, a), (_, b), (_, gd), (_, g) in zip(_leaves(p_dev), _leaves(params),
                                                   _leaves(g_dev), _leaves(g_cpu)):
            moved = (a.cpu() - b).abs() > TRACK_PARAM_ATOL
            noisy = (gd.cpu() - g).abs() > TRACK_GRAD_NOISE * g.abs()
            off += int(moved.sum())
            unexplained += int((moved & ~noisy).sum())
            total += b.numel()
        out["params_off"].append(off / total)
        out["params_off_unexplained"] = out.get("params_off_unexplained", 0) + unexplained
    if max(out["loss_rel"]) > TRAIN_TRACK_TOL or out["params_off_unexplained"]:
        raise SmokeError(f"{cfg.name}: a float train step on the card differs from the CPU "
                         f"path's: loss {out['loss_rel']} (tol {TRAIN_TRACK_TOL}), parameters "
                         f"off by more than {TRACK_PARAM_ATOL} whose gradients agree to "
                         f"{TRACK_GRAD_NOISE}: {out['params_off_unexplained']}")
    return out


def _physics_workflow(dev):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import GENERATORS
    from repro_torch.examples import physics_inference as wf
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import physics

    results = []
    for name in MODELS:
        cfg = get_config(name)
        x, y = GENERATORS[name](TRAIN_EVENTS, seed=0)
        init = physics.init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        track = _track_cpu_steps(cfg, x, y, init, dev)
        card = []  # the card's own run, for the free-running divergence (not held)
        wf.train(cfg, x, y, TRAIN_TRACK_STEPS, params=init, device=dev, losses=card)
        track["free_running_rel"] = [abs(float(a) - b) / abs(b)
                                     for a, b in zip(card, track["cpu_losses"])]
        step = _physics_step(cfg, x, y, init, dev)
        before = dict(LAUNCHES)
        step()
        torch.cuda.synchronize()
        per_step = {k: LAUNCHES[k] - before.get(k, 0) for k in ("flash_attention", "layernorm")}
        want = {"flash_attention": cfg.n_layers,
                "layernorm": 0 if cfg.norm_kind == "none" else 2 * cfg.n_layers + 1}
        if per_step != want:
            raise SmokeError(f"{name}: launches per train step {per_step}, expected {want}")
        ms = median_ms(step, 20)
        prof = profile_forward(step, iters=5)
        r = dict(model=name, batch=TRAIN_EVENTS, step_ms=ms, events_per_s=TRAIN_EVENTS / ms * 1e3,
                 launches_per_step=per_step, profile=prof, track=track, workflows=[])
        busy = prof["busy_share"]
        log(f"[train] {name:14s} train step at batch {TRAIN_EVENTS}: median {ms:.3f} ms, "
            f"{r['events_per_s']:.0f} events/s, launches/step {per_step}, device busy "
            f"{'not measured' if busy is None else f'{busy:.1%}'}, top {prof['top']}")
        log(f"[train] {name:14s} {TRAIN_TRACK_STEPS} float steps, each from the CPU run's "
            f"state: loss vs CPU max {max(track['loss_rel']):.2e} (tol {TRAIN_TRACK_TOL}), "
            f"parameters off by > {TRACK_PARAM_ATOL} after a step: at most "
            f"{max(track['params_off']):.2e} of them, each where the gradients differ by more "
            f"than {TRACK_GRAD_NOISE} of the CPU's; "
            f"free-running "
            f"card vs CPU loss by step {[f'{e:.1e}' for e in track['free_running_rel']]}")
        for policy in (None, "paper_vu13p"):
            t0 = time.perf_counter()
            w = wf.workflow(name, policy, device=dev, params=init)
            ref = JAX_WORKFLOW[(name, policy)]
            got = (w["auc_float"], w["ratio_ptq"], w["ratio_qat"])
            off = max(abs(a - b) for a, b in zip(got, ref))
            w.update(seconds=time.perf_counter() - t0, jax_reference=ref, max_off=off)
            r["workflows"].append(w)
            log(f"[train] {name:14s} workflow {w['ptq_policy']}/{w['qat_policy']}: float AUC "
                f"{got[0]:.4f} (JAX {ref[0]:.4f}), PTQ ratio {got[1]:.4f} ({ref[1]:.4f}), QAT "
                f"ratio {got[2]:.4f} ({ref[2]:.4f}); largest gap {off:.4f} (tol {WORKFLOW_TOL}); "
                f"final float loss {w['loss_float']:.4f}; {w['seconds']:.1f} s")
            if off > WORKFLOW_TOL:
                raise SmokeError(f"{name}/{policy}: the workflow's AUC / ratios {got} are more "
                                 f"than {WORKFLOW_TOL} from the JAX package's {ref}")
        results.append(r)
    return results


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [("/".join(path), tree)]


def _bitwise_equal(a, b, label):
    """Raise unless the two trees hold the same bits (compared on a's device)."""
    import torch

    bits = {4: torch.int32, 2: torch.int16, 1: torch.uint8, 8: torch.int64}
    for (pa, ta), (pb, tb) in zip(_leaves(a), _leaves(b)):
        if pa != pb or ta.dtype != tb.dtype or ta.shape != tb.shape:
            raise SmokeError(f"{label}: {pa} / {pb} differ in name, dtype or shape")
        view = bits[ta.element_size()]
        if not torch.equal(ta.view(view), tb.to(ta.device).view(view)):
            raise SmokeError(f"{label}: {pa} differs")


def _lm_train(dev):
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention.autograd import attention_backward
    from repro_torch.kernels.layernorm.autograd import layernorm_backward
    from repro_torch.optim import AdamW
    from repro_torch.train import FailureInjector, make_train_step, run_training

    cfg = dataclasses.replace(get_config("granite-8b"), **LM_TRAIN_CUT)
    tc = TrainConfig(**LM_TRAIN)
    b, l = LM_TRAIN_SHAPE
    ds = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=l, global_batch=b))
    work = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
    try:
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        res_a = run_training(cfg, tc, ds.batch, workdir=str(work / "straight"), log_every=1,
                             device=dev)
        straight_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = dict(LAUNCHES)
        want = {"flash_attention": cfg.n_layers * tc.total_steps,
                "layernorm": (2 * cfg.n_layers + 1) * tc.total_steps}
        if {k: launches.get(k, 0) for k in want} != want:
            raise SmokeError(f"LM train launches {launches}, expected {want}")
        # the card's checkpoint restored on the CPU: bitwise the card's state
        t0 = time.perf_counter()
        on_cpu = Checkpointer(str(work / "straight" / "checkpoints")).restore(res_a.state,
                                                                            device="cpu")
        _bitwise_equal(on_cpu, res_a.state, "the card's checkpoint restored on the CPU")
        restore_s = time.perf_counter() - t0
        del on_cpu
        shutil.rmtree(work / "straight")
        # killed at step 6, resumed from the step-4 checkpoint
        t0 = time.perf_counter()
        try:
            run_training(cfg, tc, ds.batch, workdir=str(work / "faulty"), log_every=1, device=dev,
                         failure_injector=FailureInjector(fail_at_step=LM_TRAIN_FAIL_AT))
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        else:
            raise SmokeError("the failure injector did not fire")
        res_b = run_training(cfg, tc, ds.batch, workdir=str(work / "faulty"), log_every=1,
                             device=dev)
        resumed_s = time.perf_counter() - t0
        if res_b.metrics_history[0]["step"] != tc.checkpoint_every + 1:
            raise SmokeError(f"the resumed run started at {res_b.metrics_history[0]['step']}")
        _bitwise_equal(res_b.state, res_a.state, "the resumed run against the straight run")
        log(f"[train] granite-8b width, {cfg.n_layers} layers, f32, batch {b} x {l}: resumed run "
            f"(killed at step {LM_TRAIN_FAIL_AT}) bitwise equal to the straight run; the card's "
            f"checkpoint restored on the CPU bitwise equal ({restore_s:.1f} s); straight run "
            f"{straight_s:.1f} s, killed + resumed {resumed_s:.1f} s")
        del res_b
        # the step alone: time, profile, and the two backwards' share of it
        opt = AdamW(schedule=lambda s: 3e-4)
        update = make_train_step(cfg, opt)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(0).items()}
        state = res_a.state
        steps_s = [m["step_time_s"] for m in res_a.metrics_history[1:]]
        step_ms = statistics.median(steps_s) * 1e3
        prof = profile_forward(lambda: update(state, batch), iters=1)
        g = torch.Generator().manual_seed(1)
        hd = cfg.resolved_head_dim
        q, dout, out = (torch.randn(b, cfg.n_heads, l, hd, generator=g).to(dev) for _ in range(3))
        k, v = (torch.randn(b, cfg.n_kv_heads, l, hd, generator=g).to(dev) for _ in range(2))
        att_bwd_ms = time_ms(lambda: attention_backward(q, k, v, out, dout, causal=True), 3)
        x = torch.randn(b * l, cfg.d_model, generator=g).to(dev)
        gamma = torch.ones(cfg.d_model, device=dev)
        ln_bwd_ms = time_ms(lambda: layernorm_backward(x, gamma, x, rms=True, eps=cfg.norm_eps), 5)
        dev_ms = prof.get("device_ms_per_fwd")
        shares = {}
        if dev_ms:
            shares = {"attention_backward": cfg.n_layers * att_bwd_ms / dev_ms,
                      "layernorm_backward": (2 * cfg.n_layers + 1) * ln_bwd_ms / dev_ms}
        r = dict(model="granite-8b", n_layers=cfg.n_layers, dtype="float32", batch=b, seq=l,
                 step_ms=step_ms, tokens_per_s=b * l / step_ms * 1e3, peak_gb=peak_gb,
                 profile=prof, attention_backward_ms=att_bwd_ms, layernorm_backward_ms=ln_bwd_ms,
                 backward_shares=shares, launches=launches, restore_cpu_s=restore_s,
                 straight_s=straight_s, resumed_s=resumed_s,
                 losses=[m["loss"] for m in res_a.metrics_history])
        busy = prof["busy_share"]
        log(f"[train] granite-8b LM train step ({cfg.n_layers} layers, f32, {b} x {l}): median "
            f"{step_ms:.1f} ms, {r['tokens_per_s']:.0f} tokens/s, device busy "
            f"{'not measured' if busy is None else f'{busy:.1%}'}, device ms/step "
            f"{dev_ms if dev_ms is None else round(dev_ms, 2)}, peak {peak_gb:.1f} GB; losses "
            f"{[round(x, 4) for x in r['losses']]}")
        log(f"[train] granite-8b LM step top kernels {prof['top']}; attention backward "
            f"{att_bwd_ms:.2f} ms x {cfg.n_layers}, layernorm backward {ln_bwd_ms:.3f} ms x "
            f"{2 * cfg.n_layers + 1}: shares of the step's device time "
            f"{ {k: round(v, 3) for k, v in shares.items()} }")
        return r, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _ssm_replay(cfg, tc, ds, dev, run_losses) -> dict:
    """The run's steps again on the card, from its init (the same seed and
    optimizer as ``run_training``): each loss bitwise the run's, and the CPU
    path's loss (a forward) from a copy of the card's parameters before the
    step.  Returns the CPU losses, the largest gap, the final card state and
    the last batch."""
    import torch

    from repro_torch.data.loader import to_device
    from repro_torch.models import lm
    from repro_torch.models.params import map_leaves
    from repro_torch.optim import AdamW, make_schedule
    from repro_torch.train import make_train_state, make_train_step

    opt = AdamW(schedule=make_schedule(tc), b1=tc.b1, b2=tc.b2, eps=tc.eps,
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
    state = make_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(tc.seed),
                             device=dev)
    update = make_train_step(cfg, opt)
    cpu_losses, gaps = [], []
    for step in range(tc.total_steps):
        host = ds.batch(step, 0, 1)
        batch = to_device(host, dev)
        with torch.no_grad():
            params = map_leaves(lambda _, t: t.to("cpu"), state["params"])
            cpu = float(lm.loss_fn(params, cfg, {k: torch.from_numpy(v) for k, v in host.items()},
                                   device="cpu")[0])
            del params
        _, m = update(state, batch)
        card = float(m["loss"])
        if card != run_losses[step]:
            raise SmokeError(f"{cfg.name}: the replayed step {step + 1} lost {card}, the run "
                             f"{run_losses[step]}: training is not deterministic")
        cpu_losses.append(cpu)
        gaps.append(abs(card - cpu))
    if max(gaps) > SSM_TRAIN_TOL:
        raise SmokeError(f"{cfg.name}: card vs CPU losses from the card's state differ by {gaps} "
                         f"(tol {SSM_TRAIN_TOL})")
    return dict(cpu_losses=cpu_losses, loss_gaps=gaps), state, update, batch


def _ssd_backward_device_ms(dev, cfg, b, l) -> float | None:
    """Device ms of ``SSDScan``'s backward at ``cfg``'s scan shape, random
    inputs of the phase's distributions."""
    import torch

    from repro_torch.kernels.ssd_scan.autograd import ssd_backward

    s = cfg.ssm
    h, p, g, n = s.n_heads(cfg.d_model), s.head_dim, s.n_groups, s.state_dim
    gen = torch.Generator().manual_seed(h + n)
    x = [t.to(dev) for t in (torch.randn(b, l, h, p, generator=gen) * 0.5,
                             -torch.randn(b, l, h, generator=gen).abs() * 0.3,
                             torch.randn(b, l, g, n, generator=gen) * 0.5,
                             torch.randn(b, l, g, n, generator=gen) * 0.5,
                             torch.randn(b, l, h, p, generator=gen))]
    # a train forward uses y alone: the final state's cotangent is None
    return device_ms(lambda: ssd_backward(*x, None, chunk=min(s.chunk_size, l)), iters=5)


def _ssm_train(dev):
    """(d): mamba2-130m and zamba2-1.2b through run_training on the card."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.train import FailureInjector, run_training

    b, l = SSM_TRAIN_SHAPE
    results, counts = [], {}
    for name, n_layers, steps, every, fail_at in SSM_TRAIN:
        cfg = dataclasses.replace(get_config(name), dtype="float32",
                                  **({} if n_layers is None else {"n_layers": n_layers}))
        tc = TrainConfig(total_steps=steps, checkpoint_every=every, warmup_steps=1,
                         learning_rate=3e-4)
        ds = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=l, global_batch=b))
        work = Path(tempfile.mkdtemp(prefix="ssm_train_", dir=ROOT / "build"))
        try:
            torch.cuda.reset_peak_memory_stats()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            res = run_training(cfg, tc, ds.batch, workdir=str(work / "straight"), log_every=1,
                               device=dev)
            straight_s = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            apps = lm.n_shared_apps(cfg)
            want = {"ssd_scan": cfg.n_layers * steps, "flash_attention": apps * steps}
            if {k: launches.get(k, 0) for k in want} != want:
                raise SmokeError(f"{name} train launches {launches}, expected {want}")
            for k, v in launches.items():
                counts[k] = counts.get(k, 0) + v
            losses = [m["loss"] for m in res.metrics_history]
            step_ms = statistics.median(m["step_time_s"] for m in res.metrics_history[1:]) * 1e3
            resumed_s = None
            if fail_at is not None:  # killed at fail_at, resumed from the checkpoint before
                t0 = time.perf_counter()
                try:
                    run_training(cfg, tc, ds.batch, workdir=str(work / "faulty"), device=dev,
                                 failure_injector=FailureInjector(fail_at_step=fail_at))
                except RuntimeError as e:
                    if "injected failure" not in str(e):
                        raise
                else:
                    raise SmokeError("the failure injector did not fire")
                resumed = run_training(cfg, tc, ds.batch, workdir=str(work / "faulty"),
                                       log_every=1, device=dev)
                resumed_s = time.perf_counter() - t0
                if resumed.metrics_history[0]["step"] != every + 1:
                    raise SmokeError(f"{name}: the resumed run started at "
                                     f"{resumed.metrics_history[0]['step']}")
                _bitwise_equal(resumed.state, res.state, f"{name}: the resumed run against the "
                               "straight run")
                del resumed
            del res
            shutil.rmtree(work, ignore_errors=True)
            t0 = time.perf_counter()
            replay, state, update, batch = _ssm_replay(cfg, tc, ds, dev, losses)
            replay_s = time.perf_counter() - t0
            prof = profile_forward(lambda: update(state, batch), iters=1)
            del state
        finally:
            shutil.rmtree(work, ignore_errors=True)
        # the scan's backward (the plain scan recomputed and differentiated)
        # at this model's shape, against the step's device time
        bwd_ms = _ssd_backward_device_ms(dev, cfg, b, l)
        dev_ms = prof.get("device_ms_per_fwd")
        bwd_share = cfg.n_layers * bwd_ms / dev_ms if bwd_ms and dev_ms else None
        r = dict(model=name, n_layers=cfg.n_layers, dtype="float32", batch=b, seq=l,
                 step_ms=step_ms, tokens_per_s=b * l / step_ms * 1e3, peak_gb=peak_gb,
                 profile=prof, losses=losses, launches=launches, straight_s=straight_s,
                 resumed_s=resumed_s, replay_s=replay_s, ssd_backward_device_ms=bwd_ms,
                 ssd_backward_share=bwd_share, **replay)
        results.append(r)
        busy = prof["busy_share"]
        log(f"[train] {name} ({cfg.n_layers} layers, f32, {b} x {l}) run_training {steps} steps: "
            f"median step {step_ms:.1f} ms, {r['tokens_per_s']:.0f} tokens/s, device busy "
            f"{'not measured' if busy is None else f'{busy:.1%}'}, device ms/step "
            f"{dev_ms if dev_ms is None else round(dev_ms, 2)}, peak {peak_gb:.1f} GB; ssd_scan "
            f"backward {bwd_ms if bwd_ms is None else round(bwd_ms, 3)} device ms x "
            f"{cfg.n_layers} = {'not measured' if bwd_share is None else f'{bwd_share:.1%}'} "
            f"of the step; launches {launches}; losses {[round(x, 5) for x in losses]}; "
            f"vs the CPU from the card's state max |d| {max(replay['loss_gaps']):.2e} (tol {SSM_TRAIN_TOL}); "
            + ("" if resumed_s is None else f"killed at step {fail_at} and resumed: bitwise the "
               f"straight run ({resumed_s:.1f} s); ") + f"top {prof['top']}")
    return results, counts


def _mesh_train(dev):
    """(e): the sharded step on a one-card mesh against the unsharded step,
    and the sharded state's checkpoint restored onto the rules' shardings."""
    import copy
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ParallelismConfig, get_config
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.data.loader import to_device
    from repro_torch.distributed import ShardingRules
    from repro_torch.distributed.sharding import gather
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamW
    from repro_torch.train import (make_train_state, make_train_step, shard_train_state,
                                   train_state_shardings)

    b, l = SSM_TRAIN_SHAPE
    cfg = dataclasses.replace(get_config("mamba2-130m"), dtype="float32")
    ds = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=l, global_batch=b))
    work = Path(tempfile.mkdtemp(prefix="mesh_", dir=ROOT / "build"))
    dist.init_process_group("nccl", init_method=f"file://{work / 'pg'}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        rules = ShardingRules(mesh=mesh, plan=ParallelismConfig())
        opt = AdamW(schedule=lambda s: 3e-4)
        shardings = train_state_shardings(cfg, opt, rules)
        state0 = make_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(0),
                                  device=dev)
        plain = copy.deepcopy(state0)
        sharded = shard_train_state(copy.deepcopy(state0), shardings)
        steps = {"plain": make_train_step(cfg, opt),
                 "sharded": make_train_step(cfg, opt, mesh=mesh, rules=rules)}
        LAUNCHES.clear()
        ms = {"plain": [], "sharded": []}
        for i in range(MESH_TRAIN_STEPS):
            batch = to_device(ds.batch(i, 0, 1), dev)
            for kind, st in (("plain", plain), ("sharded", sharded)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps[kind](st, batch)
                torch.cuda.synchronize()
                ms[kind].append((time.perf_counter() - t0) * 1e3)
        counts = dict(LAUNCHES)
        if counts.get("ssd_scan", 0) != 2 * MESH_TRAIN_STEPS * cfg.n_layers:
            raise SmokeError(f"sharded / unsharded steps launched {counts}")
        gathered = _map_leaves_dict(gather, sharded)
        _bitwise_equal(gathered, plain, "the sharded step on a one-card mesh against the "
                       "unsharded step")
        ckpt = Checkpointer(str(work / "ckpt"))
        ckpt.save(MESH_TRAIN_STEPS, sharded, blocking=True)
        restored = ckpt.restore(state0, shardings=shardings)
        if not all(isinstance(t, DTensor) for _, t in _leaves(restored)):
            raise SmokeError("restore(shardings=) did not place every leaf as a DTensor")
        _bitwise_equal(_map_leaves_dict(gather, restored), plain,
                       "the sharded checkpoint restored onto the rules' shardings")
        r = dict(model=cfg.name, batch=b, seq=l, steps=MESH_TRAIN_STEPS, step_ms=ms,
                 launches=counts)
        log(f"[train] sharded step on a one-card mesh (NCCL, world 1), {cfg.name} f32 {b} x {l}: "
            f"{MESH_TRAIN_STEPS} steps bitwise the unsharded step's; restore(shardings=) bitwise; "
            f"step ms unsharded {[round(x, 1) for x in ms['plain']]}, sharded "
            f"{[round(x, 1) for x in ms['sharded']]}")
        return r, counts
    finally:
        dist.barrier()
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)


def _map_leaves_dict(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves_dict(fn, v) for k, v in tree.items()}
    return fn(tree)


def phase_train(dev):
    """Training: (a) the gradients of the three autograd.Functions on the
    card and the two kernels that must refuse grad; (b) the physics
    workflow; (c) the granite-width LM run with its bitwise restart; (d)
    mamba2-130m and zamba2-1.2b trained; (e) the sharded step on a one-card
    mesh.  Returns (results, launch counts of the windows of (b)-(e))."""
    import torch

    from repro_torch.kernels import LAUNCHES

    grads = []
    for shape, hkv, causal, window, kv_len, dtype, v_dim in TRAIN_ATT_CASES:
        for mode in ("safe", "lut") if dtype == "float32" else ("safe",):
            c = _attention_grad_case(dev, shape, hkv, causal, window, kv_len, dtype, mode, v_dim)
            grads.append(c)
            log(f"[grad] attention {shape} V {c['v_dim']} kv {hkv} {dtype} {mode} causal "
                f"{causal} window {window} kv_len {kv_len}: max |d| {c['max_abs_err']}  fwd+bwd "
                f"{c['fwd_bwd_ms']:.3f} ms (plain {c['plain_fwd_bwd_ms']:.3f})  "
                f"{'ok' if c['ok'] else 'FAILED'}")
    for rows, k, rms, use_lut in TRAIN_LN_CASES:
        c = _layernorm_grad_case(dev, rows, k, rms, use_lut)
        grads.append(c)
        log(f"[grad] layernorm ({rows}, {k}) {c['mode']}: max |d| {c['max_abs_err']}  fwd+bwd "
            f"{c['fwd_bwd_ms']:.3f} ms (plain {c['plain_fwd_bwd_ms']:.3f})  "
            f"{'ok' if c['ok'] else 'FAILED'}")
    for shape in TRAIN_SSD_CASES:
        for dtype in ("float32", "bfloat16"):
            c = _ssd_grad_case(dev, *shape, dtype)
            grads.append(c)
            log(f"[grad] ssd_scan {shape[:5]} groups {shape[5]} {dtype}: max |d| "
                f"{c['max_abs_err']}  fwd+bwd {c['fwd_bwd_ms']:.3f} ms (plain "
                f"{c['plain_fwd_bwd_ms']:.3f})  {'ok' if c['ok'] else 'FAILED'}")
    bad = [c for c in grads if not c["ok"]]
    if bad:
        raise SmokeError(f"{len(bad)} gradient checks failed: {bad}")
    raised = _no_backward_raises(dev)
    # (b) and (c) train under deterministic algorithms: the same run gives
    # the same bits on every call (the backward of a gather, for one, would
    # otherwise add with atomics in no fixed order, and training amplifies
    # such differences); uninitialised memory is left as it is (filling it
    # is a debugging aid, not part of determinism)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        LAUNCHES.clear()  # the training path's window starts here
        physics = _physics_workflow(dev)
        physics_counts = dict(LAUNCHES)
        lm_run, lm_counts = _lm_train(dev)
        ssm_runs, ssm_counts = _ssm_train(dev)
        mesh_run, mesh_counts = _mesh_train(dev)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
    windows = (physics_counts, lm_counts, ssm_counts, mesh_counts)
    counts = {k: sum(w.get(k, 0) for w in windows) for k in set().union(*windows)}
    for kname in ("flash_attention", "layernorm", "ssd_scan"):
        if counts.get(kname, 0) <= 0:
            raise SmokeError(f"{kname} was never launched on the training path")
    log(f"[train] training path launches: {counts}")
    return dict(grads=grads, no_backward_raises=raised, physics=physics, lm=lm_run,
                ssm=ssm_runs, mesh=mesh_run), counts


def _workflow_seed_spread(dev, seeds) -> dict:
    """The float / PTQ / QAT physics workflow of each encoder from ``seeds``
    more init seeds (1 .. seeds), under the paper-optimal policies and
    paper_vu13p: how far the AUCs move with the init alone."""
    from repro_torch.examples import physics_inference as wf

    spread = {}
    for name in MODELS:
        for policy in (None, "paper_vu13p"):
            rows = [(w["auc_float"], w["ratio_ptq"], w["ratio_qat"]) for w in (
                wf.workflow(name, policy, device=dev, seed=seed) for seed in range(1, seeds + 1))]
            if not rows:
                continue
            cols = list(zip(*rows))
            r = spread[f"{name}/{policy}"] = {
                "values": rows, "mean": [statistics.fmean(c) for c in cols],
                "stdev": [statistics.stdev(c) if len(c) > 1 else 0.0 for c in cols]}
            log(f"[seeds] {name:14s} {policy or 'paper-optimal':13s} seeds 1-{seeds}: float AUC "
                f"/ PTQ ratio / QAT ratio mean {[round(m, 4) for m in r['mean']]} stdev "
                f"{[round(x, 4) for x in r['stdev']]}")
    return spread


# ------------------------------------------------------------------- main --


# --------------------------------------------------------------- phase 12 --

# Phase 12's checks: the FLOPs of a call counted on the card (its kernel
# launches priced by roofline.kernel_costs) and on meta (the plain versions'
# volume re-priced by roofline.analysis.fused_work) agree to ROOFLINE_FLOP_REL;
# the fused H100 bound of a call may exceed the device time an earlier phase
# measured by ROOFLINE_BOUND_SLACK at most (a larger bound is a wrong count).
ROOFLINE_FLOP_REL = 1e-6
ROOFLINE_BOUND_SLACK = 1.05
ROOFLINE_BY = {"compute": "operations", "memory": "bytes", "collective": "collective"}


def _lm_params(cfg, dev):
    """``cfg``'s parameters on ``dev``: drawn with a CUDA generator on the
    card, abstract on meta."""
    import torch

    from repro_torch.models import lm

    if dev.type == "meta":
        return lm.abstract_params(cfg)
    return lm.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)


def _lm_caches(cfg, batch, max_len, dtype, quantized, dev):
    import torch

    from repro_torch.models import lm

    if dev.type != "meta":
        return lm.init_caches(cfg, batch, max_len, dtype, quantized=quantized, device=dev)
    return {g: {k: torch.empty(s, dtype=dt, device="meta") for k, (s, dt) in leaves.items()}
            for g, leaves in lm.abstract_caches(cfg, batch, max_len, dtype, quantized).items()}


def _lm_prefill_call(cfg, batch, length, dev, params):
    """A closure of ``lm.prefill`` of ``batch`` x ``length`` tokens (int32,
    as the dry run's inputs) under ``cfg``'s policy, with caches as the
    phases serve it (float32 int8 caches under int8_serve, bf16 ones under
    float), and the tensors it allocates."""
    import torch

    from repro_torch.core import precision
    from repro_torch.models import lm

    quantized = precision.resolve_model_plan(cfg).int8_kv_cache
    caches = _lm_caches(cfg, batch, length, torch.float32 if quantized else torch.bfloat16,
                        quantized, dev)
    tokens = (torch.empty if dev.type == "meta" else torch.zeros)(
        (batch, length), dtype=torch.int32, device=dev)
    return (lambda: lm.prefill(params, cfg, {"tokens": tokens}, caches, device=dev),
            (params, caches, tokens))


def _prefill_floor(cfg, batch, length) -> tuple[float, float, str]:
    """(TFLOP, bound ms, by) of ``lm.prefill`` of ``batch`` x ``length``
    tokens under ``cfg`` (its precision policy applied): the fused H100
    roofline of the step counted on meta (phases 9c, 10c)."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import precision
    from repro_torch.core.latency_model import roofline_by_type
    from repro_torch.device import meta_trace
    from repro_torch.roofline import analysis, op_counter

    meta = torch.device("meta")
    with meta_trace(), torch.no_grad():
        params = precision.apply_plan_to_params(_lm_params(cfg, meta),
                                                precision.resolve_model_plan(cfg))
        fn, _ = _lm_prefill_call(cfg, batch, length, meta, params)
        _, count = op_counter.count(fn)
    flops, nbytes = analysis.fused_work(count, cfg, ShapeConfig("prefill", length, batch,
                                                                "prefill"))
    terms = roofline_by_type(flops, nbytes, 0.0)
    return sum(flops.values()) / 1e12, terms.bound_s * 1e3, ROOFLINE_BY[terms.dominant]


def _roofline_calls(earlier):
    """Phase 12's calls: (label, cfg, analysis shape, device ms an earlier
    phase measured or None, build(dev) -> (call, allocated tensors))."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import precision
    from repro_torch.models import lm, physics
    from repro_torch.models import params as params_lib

    earlier = earlier or {}

    def dev_ms(records, **match):
        rec = next((r for r in records or () if all(r.get(k) == v for k, v in match.items())),
                   None)
        return None if rec is None else (rec.get("profile") or {}).get("device_ms_per_fwd")

    calls = []
    for name in MODELS:  # phase 3, batch 8192
        for policy in POLICIES:
            cfg = dataclasses.replace(get_config(name), precision=policy)
            bt = max(BATCHES)

            def build(dev, cfg=cfg, bt=bt):
                spec = physics.param_spec(cfg)
                params = (params_lib.abstract_params(spec) if dev.type == "meta" else
                          physics.init_params(cfg, torch.Generator().manual_seed(SEED),
                                              device=dev))
                params = precision.apply_plan_to_params(params,
                                                        precision.resolve_model_plan(cfg))
                x = (torch.empty if dev.type == "meta" else torch.zeros)(
                    (bt, cfg.seq_len, cfg.input_vec_size), device=dev)
                return (lambda: physics.forward(params, cfg, x, device=dev)), (params, x)

            calls.append((f"{name} {policy} forward {bt}", cfg,
                          ShapeConfig(name, cfg.seq_len, bt, "prefill"),
                          dev_ms(earlier.get("models"), model=name, policy=policy, batch=bt),
                          build))

    def prefill_call(label, cfg, bt, length, records, **match):
        def build(dev):
            params = precision.apply_plan_to_params(_lm_params(cfg, dev),
                                                    precision.resolve_model_plan(cfg))
            return _lm_prefill_call(cfg, bt, length, dev, params)

        calls.append((label, cfg, ShapeConfig(cfg.name, length, bt, "prefill"),
                      dev_ms(records, **match), build))

    g8 = dataclasses.replace(get_config("granite-8b"), n_layers=GRANITE_TIME_LAYERS)
    bt = max(GRANITE_TIME_BATCHES)
    prefill_call(f"granite-8b {g8.n_layers} L prefill {bt} x {GRANITE_TIME_LEN}", g8, bt,
                 GRANITE_TIME_LEN, (earlier.get("dense") or {}).get("granite_8b", {}).get(
                     "timings"), kind="prefill", batch=bt)
    m2 = dataclasses.replace(get_config(MAMBA), n_layers=MAMBA_LAYERS)
    bt = max(MAMBA_TIME_BATCHES)
    prefill_call(f"mamba2-130m {m2.n_layers} L prefill {bt} x {MAMBA_TIME_LEN}", m2, bt,
                 MAMBA_TIME_LEN, (earlier.get("mamba") or {}).get("timings"), kind="prefill",
                 batch=bt)
    for name, layers, phase, key, bts, length in (
            (MOE_SERVE, MOE_SERVE_LAYERS, "int8_moe", "moe_prefill", MOE_PREFILL_BATCHES,
             MOE_PREFILL_LEN),
            (MLA, MLA_SERVE_LAYERS, "mla", "prefill", MLA_PREFILL_BATCHES, MLA_PREFILL_LEN)):
        base = dataclasses.replace(get_config(name), n_layers=layers)
        for policy in (base.serve_policy, "float"):
            pcfg = dataclasses.replace(base, precision=policy)
            prefill_call(f"{name} {layers} L {policy} prefill {max(bts)} x {length}", pcfg,
                         max(bts), length, (earlier.get(phase) or {}).get(key), policy=policy,
                         batch=max(bts))
    families = (earlier.get("families") or {}).get("timings")
    bt = max(FRONTEND_BATCHES)
    for name in (AUDIO, VLM):
        base = dataclasses.replace(get_config(name), n_layers=FRONTEND_TIME_LAYERS[name])
        for policy in ("float", base.serve_policy):
            pcfg = dataclasses.replace(base, precision=policy)

            def build(dev, pcfg=pcfg, name=name):
                plan = precision.resolve_model_plan(pcfg)
                params = precision.apply_plan_to_params(_lm_params(pcfg, dev), plan)
                new = torch.empty if dev.type == "meta" else torch.zeros
                if name == AUDIO:
                    frames = new((bt, AUDIO_FRAMES, pcfg.frontend_dim), dtype=torch.bfloat16,
                                 device=dev)
                    return (lambda: lm.forward(params, pcfg, {"frames": frames}, device=dev),
                            (params, frames))
                n_img, quantized = pcfg.n_frontend_tokens, plan.int8_kv_cache
                batch = {"patches": new((bt, n_img, pcfg.frontend_dim), dtype=torch.bfloat16,
                                        device=dev),
                         "tokens": new((bt, VLM_TEXT), dtype=torch.int32, device=dev)}
                caches = _lm_caches(pcfg, bt, n_img + VLM_TEXT + VLM_DECODE_STEPS,
                                    torch.float32 if quantized else torch.bfloat16, quantized,
                                    dev)
                return (lambda: lm.prefill(params, pcfg, batch, caches, device=dev),
                        (params, caches, batch))

            length = AUDIO_FRAMES if name == AUDIO else pcfg.n_frontend_tokens + VLM_TEXT
            what = "forward" if name == AUDIO else "prefill"
            calls.append((f"{name} {base.n_layers} L {policy} {what} {bt} x {length}", pcfg,
                          ShapeConfig(name, length, bt, "prefill"),
                          dev_ms(families, model=name, policy=policy, batch=bt), build))
    return calls


def _card_mesh_check(dev) -> dict:
    """(c): granite-8b at phase 6's depth, ``lm.prefill`` of 8 x 2048 on the
    one-card mesh: the dry run's argument bytes against the parameters,
    caches and tokens allocated on the card for the same prefill."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=GRANITE_TIME_LAYERS)
    bt, length = max(GRANITE_TIME_BATCHES), GRANITE_TIME_LEN
    shape = ShapeConfig("smoke_prefill", length, bt, "prefill")
    mesh = dryrun.make_mesh("card")
    trace = dryrun.trace_prefill(cfg, shape, mesh,
                                 ShardingRules(mesh=mesh, plan=dryrun.plan_for(cfg, shape)))
    _, held = _lm_prefill_call(cfg, bt, length, dev, _lm_params(cfg, dev))
    allocated = _nbytes(held)
    del held
    torch.cuda.empty_cache()
    argument = trace.memory_stats["argument_bytes"]
    if argument != allocated:
        raise SmokeError(f"[roofline] granite-8b {cfg.n_layers} L on mesh card: dry-run "
                         f"argument bytes {argument} != {allocated} allocated on the card")
    log(f"[roofline] (c) granite-8b {cfg.n_layers} L prefill {bt} x {length} on mesh card: "
        f"argument bytes {argument} = the parameters, caches and tokens allocated on the card")
    return dict(argument_bytes=argument, allocated_bytes=allocated,
                output_bytes=trace.memory_stats["output_bytes"])


def phase_roofline(dev, earlier=None):
    """Phase 12: the roofline counts against the card.  ``earlier``: the
    results of phases 3-11, whose device times it reads (run alone, it has
    none, and skips (b)).  Returns (results, launch counts of the window)."""
    import torch

    from repro_torch.core.latency_model import H100, roofline_by_type
    from repro_torch.device import meta_trace
    from repro_torch.examples.physics_inference import fpga_latency
    from repro_torch.kernels import LAUNCHES
    from repro_torch.roofline import analysis, op_counter

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"[roofline] {smi}; peaks {dict(H100.peaks)} FLOP/s, HBM {H100.hbm_bw:.3g} B/s")
    meta = torch.device("meta")
    LAUNCHES.clear()  # the roofline path's window starts here
    results, failures = [], []
    for label, cfg, shape, measured, build in _roofline_calls(earlier):
        with torch.no_grad():
            fn, held = build(dev)
            torch.cuda.synchronize()
            with op_counter.OpCounter() as c:
                fn()
            torch.cuda.synchronize()
        card = c.result()
        del fn, held
        with meta_trace(), torch.no_grad():
            fn, held = build(meta)
            with op_counter.OpCounter() as c:
                fn()
        fused, nbytes = analysis.fused_work(c.result(), cfg, shape)
        del fn, held
        terms = roofline_by_type(fused, nbytes, 0.0)
        card_flops, meta_flops = card.total_flops, sum(fused.values())
        rel = abs(card_flops - meta_flops) / max(card_flops, meta_flops, 1.0)
        bound = terms.bound_s * 1e3
        useful = analysis.model_flops(cfg, shape) + analysis.attention_flops(cfg, shape)
        rec = dict(call=label, flops_card=card.flops, flops_meta_fused=fused,
                   flops_rel_diff=rel, bytes_card=card.hbm_bytes, bytes_fused=nbytes,
                   launches=dict(collections.Counter(k.kernel for k in card.launches)),
                   dominant=terms.dominant, bound_ms=bound, device_ms=measured,
                   bound_share=None if not measured else bound / measured,
                   model_flops_share=None if not measured else
                   useful / (measured * 1e-3 * H100.peak_for("bfloat16")))
        results.append(rec)
        by_type = ", ".join(f"{t} {f / 1e12:.4g}" for t, f in sorted(card.flops.items()))
        log(f"[roofline] {label}: TFLOP {by_type} (meta fused {meta_flops / 1e12:.6g}, rel "
            f"{rel:.1e}); bytes card {card.hbm_bytes / 1e9:.4g} GB, fused {nbytes / 1e9:.4g} GB; "
            f"{terms.dominant}-bound {bound:.4f} ms; device ms "
            f"{'not measured' if not measured else f'{measured:.4f}'}"
            + ("" if not measured else f"; bound {rec['bound_share']:.1%} of it, model FLOPs "
               f"{rec['model_flops_share']:.1%} of bf16 peak") + f"  [{smi}]")
        if rel > ROOFLINE_FLOP_REL:
            failures.append(f"{label}: card {card_flops:.6e} vs meta {meta_flops:.6e} FLOPs")
        if measured and bound > ROOFLINE_BOUND_SLACK * measured:
            failures.append(f"{label}: bound {bound:.4f} ms > {ROOFLINE_BOUND_SLACK} x device "
                            f"{measured:.4f} ms")
        torch.cuda.empty_cache()
    if failures:
        raise SmokeError("[roofline] " + "; ".join(failures))
    card_mesh = _card_mesh_check(dev)
    fpga = []
    for name in MODELS:  # (d): a print, not a check
        for est in fpga_latency(name):
            card_ms = {p: next((r["median_ms"] for r in (earlier or {}).get("models") or ()
                                if r["model"] == name and r["policy"] == p and r["batch"] == 1),
                               None) for p in POLICIES}
            fpga.append(dict(model=name, reuse=est.reuse, clock_ns=est.clock_ns,
                             interval_cycles=est.interval_cycles, fpga_us=est.latency_us,
                             card_batch1_ms=card_ms))
            log(f"[roofline] (d) {name} FPGA model R{est.reuse}: {est.latency_us:.3f} us "
                f"(II {est.interval_cycles}, clk {est.clock_ns} ns); the card at batch 1: "
                + ", ".join(f"{p} {'not measured' if v is None else f'{v * 1e3:.1f} us'}"
                            for p, v in card_ms.items()))
    counts = dict(LAUNCHES)  # the roofline path's window ends here
    return dict(calls=results, card_mesh=card_mesh, fpga=fpga, nvidia_smi=smi), counts


# ---------------------------------------------------------------- phase 13 --

# The rest of the serving engine (phase 13), granite-8b bf16 at its published
# widths and GRANITE_SERVE_LAYERS of its 36 layers, phase 7b's 16 requests x
# SERVE_NEW tokens (max_batch 8, 4 decode steps per dispatch).  "Identical"
# streams may part only at a step whose top-two margin (the card's direct
# greedy loop, float32 caches) is under phase 7's DENSE_TOL.
ENGINE_LAYOUTS = ({}, dict(kv_layout="paged", kv_page_size=16, kv_prefix_cache=True))
ENGINE_NBEST = 4
#: (c) the victim tier: a pool below the run's registered pages, so the
#: shared prefix's chain (evicted LRU-first) spills, and a ring that holds
#: every spill
ENGINE_TIER = dict(kv_layout="paged", kv_page_size=16, kv_prefix_cache=True, kv_pages=513)
ENGINE_HOST_PAGES = 1024
#: (f) the reference's Pallas row: what needs the cache-extending program,
#: asked for on the card and, the same ServeConfig, on the port's CPU engine
ENGINE_PALLAS_SC = dict(SERVE_CHECK_SC, kv_layout="paged", kv_page_size=16,
                        kv_prefix_cache=True, kv_preemption=True, prefill_chunk=32,
                        speculative=True, spec_tokens=3, policy="int8_serve")
ENGINE_PALLAS_DISABLED = ("prefill_chunk", "prefill-skip", "kv_preemption", "speculative")


def _same_streams(label, got, want, cfg, params, prompts, dev):
    """``got`` equals ``want`` request for request, or parts from it at a
    step whose top-two margin in the card's direct greedy loop is under
    DENSE_TOL; returns those close calls."""
    close = []
    for i, (a, b) in enumerate(zip(got, want)):
        if len(a) != len(b):
            raise SmokeError(f"{label} request {i}: {len(a)} tokens, expected {len(b)}")
        k = next((k for k in range(len(b)) if a[k] != b[k]), None)
        if k is None:
            continue
        _, margins = _direct_greedy(cfg, params, prompts[i], k + 1, dev)
        if margins[k] >= DENSE_TOL:
            raise SmokeError(f"{label} request {i} parts at step {k} (margin {margins[k]:.2e} "
                             f">= {DENSE_TOL})")
        close.append(dict(request=i, step=k, margin=margins[k]))
    return close


def _sync_free_dispatches(eng):
    """Wrap ``eng.executor.dispatch`` so that every steady-state pure decode
    dispatch (nothing admitted, preempted or extended, an empty queue and a
    device carry to merge) runs under ``torch.cuda.set_sync_debug_mode
    ("error")``: a synchronising call in it raises.  Returns the list the
    checked dispatches are counted into; ``del executor.dispatch`` undoes
    the wrap."""
    import torch

    ex, checked = eng.executor, []
    real = ex.dispatch

    def dispatch(decision):
        pure = (not decision.admissions and not decision.prefill_groups
                and not decision.preempted and not decision.extend_slots
                and not eng.scheduler.queue and ex._carry is not None)
        if not pure:
            return real(decision)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(decision)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked.append(len(out.decode_set))
        return out

    ex.dispatch = dispatch
    return checked


def _engine_async(base, params, prompts, dev, smi) -> tuple[dict, dict]:
    """(a): the sync and the async loop per layout, then the async loop
    traced (overlap mode) with its pure decode dispatches checked for
    synchronising calls, and one async decode step profiled.  Returns (the
    records, the sync dense streams)."""
    import torch

    from repro_torch.configs import ServeConfig
    from repro_torch.serve.api import Engine

    with warnings.catch_warnings():  # the first engine on the card pays its warm-up here
        warnings.simplefilter("ignore", RuntimeWarning)
        _run_engine(Engine(base, params, ServeConfig(**SERVE_SC), device=dev), prompts[:8], 4)
    out, ref = {}, None
    for layout in ENGINE_LAYOUTS:
        label = "dense" if not layout else "paged + prefix cache"
        rec = {}
        for loop in ("sync", "async"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # prefill-skip needs extend
                eng = Engine(base, params, ServeConfig(**SERVE_SC, **layout,
                                                       async_loop=loop == "async"), device=dev)
            streams, metrics, decodes, grew, _ = _checked_engine_run(
                eng, prompts, SERVE_NEW, f"[engine] (a) {label} {loop}")
            rec[loop] = dict(metrics, decode_dispatches=decodes, launches=grew)
            rec[f"{loop}_streams"] = streams
            del eng
        ref = ref or rec["sync_streams"]
        rec["close_calls"] = _same_streams(f"[engine] (a) {label} async vs sync",
                                           rec["async_streams"], rec["sync_streams"], base,
                                           params, prompts, dev)
        rec["close_calls"] += _same_streams(f"[engine] (a) {label} vs dense", rec["sync_streams"],
                                            ref, base, params, prompts, dev)
        sc = ServeConfig(**SERVE_SC, **layout, async_loop=True, trace_phases=True,
                         phase_mode="overlap")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            eng = Engine(base, params, sc, device=dev)
        checked = _sync_free_dispatches(eng)
        streams, traced = _run_engine(eng, prompts, SERVE_NEW)
        del eng.executor.dispatch
        if eng._tracer.fences:
            raise SmokeError(f"[engine] (a) {label}: the overlap tracer fenced "
                             f"{eng._tracer.fences} times")
        if not checked:
            raise SmokeError(f"[engine] (a) {label}: no steady-state pure decode dispatch ran")
        rec["close_calls"] += _same_streams(f"[engine] (a) {label} traced async", streams,
                                            rec["sync_streams"], base, params, prompts, dev)
        ph = eng.telemetry["phases"]
        rec.update(traced_async=traced, sync_free_dispatches=len(checked),
                   overlap_efficiency=ph["overlap_efficiency"],
                   device_overlap_s=ph["device_overlap_s"], host_bubble_s=ph["host_bubble_s"],
                   fences=eng._tracer.fences)
        del eng
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            eng = Engine(base, params, ServeConfig(**SERVE_SC, **layout, async_loop=True),
                         device=dev)
        rec["async_profile"] = _decode_profile(eng, prompts)
        del eng
        torch.cuda.empty_cache()
        s, a, p = rec["sync"], rec["async"], rec["async_profile"]
        busy = "not measured" if p["busy_share"] is None else f"{p['busy_share']:.1%}"
        log(f"[engine] (a) {label}: sync {s['tokens_per_s']:.1f} / async "
            f"{a['tokens_per_s']:.1f} output tokens/s ({a['tokens_per_s'] / s['tokens_per_s']:.3f}"
            f"x), TTFT p50 {s['ttft_ms_p50']:.1f} / {a['ttft_ms_p50']:.1f} ms, p95 "
            f"{s['ttft_ms_p95']:.1f} / {a['ttft_ms_p95']:.1f} ms, ITL p50 {s['itl_ms_p50']:.2f} / "
            f"{a['itl_ms_p50']:.2f} ms; traced async: overlap_efficiency "
            f"{rec['overlap_efficiency']:.3f}, host_bubble_s {rec['host_bubble_s']:.3f}, "
            f"device_overlap_s {rec['device_overlap_s']:.3f}, 0 fences; {len(checked)} "
            f"steady-state decode dispatches under sync debug mode 'error', none synchronised; "
            f"one async decode step busy {busy}; streams identical (close calls "
            f"{rec['close_calls'] or 'none'})  [{smi}]")
        out[label] = {k: v for k, v in rec.items() if not k.endswith("_streams")}
    return out, ref


def _engine_nbest(base, params, prompts, ref, dev) -> dict:
    """(b): n-best on the card, where the scheduler cannot fork (the kernel
    prefill is not replayable): every sibling prefills on its own."""
    from repro_torch.configs import ServeConfig
    from repro_torch.serve import SamplingParams
    from repro_torch.serve.api import Engine

    sc = ServeConfig(**SERVE_SC, **ENGINE_LAYOUTS[1])
    picks = prompts[:2]

    def run(sp):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            eng = Engine(base, params, sc, device=dev)
        groups = [eng.submit(p, sp, n=ENGINE_NBEST) for p in picks]
        fin = eng.generate()
        return [[fin[h.uid].generated for h in g] for g in groups], eng

    greedy, eng = run(SamplingParams(max_new_tokens=SERVE_NEW))
    tel = eng.telemetry
    if eng.scheduler.fork_enabled or tel["forks"]:
        raise SmokeError(f"[engine] (b) forks on the card: {tel['forks']}")
    if tel["prompts_admitted"] != ENGINE_NBEST * len(picks):
        raise SmokeError(f"[engine] (b) {tel['prompts_admitted']} prefills, expected "
                         f"{ENGINE_NBEST * len(picks)}")
    close = []
    for i, g in enumerate(greedy):
        close += _same_streams(f"[engine] (b) greedy siblings of request {i}", g,
                               [ref[i]] * ENGINE_NBEST, base, params, [picks[i]] * ENGINE_NBEST,
                               dev)
    del eng
    seeded = SamplingParams(max_new_tokens=SERVE_NEW, temperature=0.8, seed=11)
    first, eng = run(seeded)
    second, eng = run(seeded)
    if first != second:
        raise SmokeError("[engine] (b) two runs of the seeded n-best group differ")
    if any(len({tuple(s) for s in g}) < 2 for g in first):
        raise SmokeError("[engine] (b) seeded siblings did not diverge")
    log(f"[engine] (b) n-best: {len(picks)} prompts x n={ENGINE_NBEST}: forks 0 (fork_enabled "
        f"False on the card), {tel['prompts_admitted']} prefills; greedy siblings equal the n=1 "
        f"stream (close calls {close or 'none'}); seeded siblings diverge and two runs are "
        f"identical")
    return dict(forks=tel["forks"], prefills=tel["prompts_admitted"], close_calls=close)


def _engine_tier(base, params, prompts, dev, smi) -> dict:
    """(c): the victim tier.  A pool smaller than the run's registered pages
    evicts the shared prefix's chain; a second wave of the shared-prefix
    prompts swaps it back.  Each flush is timed (synchronised) and checked:
    the rows a page spilled are the rows its swap-in writes back."""
    import torch

    from repro_torch.configs import ServeConfig
    from repro_torch.serve.api import Engine

    waves = [prompts, prompts[:SERVE_SHARED_REQUESTS]]
    runs = {}
    for host_pages in (ENGINE_HOST_PAGES, 0):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            eng = Engine(base, params, ServeConfig(**SERVE_SC, **ENGINE_TIER,
                                                   kv_host_pages=host_pages), device=dev)
        mgr = eng.executor.cache_mgr
        real, spilled = mgr.apply_flush, {}
        moved = dict(pages=0, seconds=0.0, checked=0, flushes=0)

        def flush(caches, ops, mgr=mgr, real=real, spilled=spilled, moved=moved):
            """``apply_flush`` with its victim-tier part (spills, swap-ins)
            timed alone and checked, the rest (copies, the table) after."""
            ops = dict(ops or {})
            tier = {k: ops.pop(k) for k in ("spills", "swap_ins") if k in ops}
            for host, page in zip(*tier.get("spills", ((), ()))):
                spilled[int(host)] = {n: caches["layers"][n][:, int(page)].clone()
                                      for n in mgr._host_pool}
            swaps = list(zip(*tier.get("swap_ins", ((), ()))))
            n = len(tier.get("spills", ((),))[0]) + len(swaps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            caches = real(caches, tier)
            torch.cuda.synchronize()
            moved["seconds"] += time.perf_counter() - t0
            moved["pages"] += n
            moved["flushes"] += bool(n)
            for host, page in swaps:
                for name, rows in spilled[int(host)].items():
                    if not torch.equal(caches["layers"][name][:, int(page)], rows):
                        raise SmokeError(f"[engine] (c) swapped-in {name} rows of page {page} "
                                         f"differ from the rows spilled to ring slot {host}")
                moved["checked"] += 1
            return real(caches, ops)

        mgr.apply_flush = flush
        streams = [_run_engine(eng, w, SERVE_NEW)[0] for w in waves]
        del mgr.apply_flush
        mgr.check_invariants()
        tel = eng.telemetry
        page_bytes = sum(r[:, 0].numel() * r.element_size() for r in mgr._host_pool.values())
        runs[host_pages] = dict(streams=streams, swap_outs=tel["swap_outs"],
                                swap_ins=tel["swap_ins"], host_evictions=tel["host_evictions"],
                                page_evictions=tel["page_evictions"],
                                prefix_hits=tel["prefix_hits"], checked=moved["checked"],
                                bytes=moved["pages"] * page_bytes, flush_s=moved["seconds"],
                                flushes=moved["flushes"])
        del eng, mgr
        torch.cuda.empty_cache()
    on, off = runs[ENGINE_HOST_PAGES], runs[0]
    if not (on["swap_outs"] > 0 and on["swap_ins"] > 0 and on["checked"] == on["swap_ins"]):
        raise SmokeError(f"[engine] (c) spills {on['swap_outs']}, swap-ins {on['swap_ins']}, "
                         f"rows checked {on['checked']}")
    close = []
    for w, prompts_w in enumerate(waves):
        close += _same_streams(f"[engine] (c) wave {w} with the tier vs without",
                               on["streams"][w], off["streams"][w], base, params, prompts_w, dev)
    rate = on["bytes"] / on["flush_s"] / 1e9 if on["flush_s"] else float("nan")
    log(f"[engine] (c) victim tier ({ENGINE_TIER['kv_pages'] - 1} device pages, "
        f"{ENGINE_HOST_PAGES} host pages): {on['swap_outs']} spills, {on['swap_ins']} swap-ins "
        f"(rows bitwise the spilled rows), {on['host_evictions']} ring evictions, "
        f"{on['page_evictions']} device evictions; {on['bytes'] / 1e6:.1f} MB moved in "
        f"{on['flushes']} flushes, {on['flush_s'] * 1e3:.2f} ms of the tier's flushes = {rate:.2f} "
        f"GB/s; streams equal the run "
        f"without the tier ({off['page_evictions']} evictions; close calls {close or 'none'})"
        f"  [{smi}]")
    return {"with_tier": {k: v for k, v in on.items() if k != "streams"},
            "without": {k: v for k, v in off.items() if k != "streams"},
            "gb_per_s": rate, "close_calls": close}


def _engine_router(base, params, prompts, ref, dev) -> dict:
    """(d): two replicas on the one card behind the router: one engine's
    streams, 8 requests admitted on each, and the router's allocation the
    two KV pools (the weights are shared by reference)."""
    import torch

    from repro_torch.configs import ServeConfig
    from repro_torch.kernels import LAUNCHES
    from repro_torch.serve.router import ReplicaRouter

    weights = _nbytes(params)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    router = ReplicaRouter(base, params, ServeConfig(**SERVE_SC, replicas=2), device=dev)
    grew = torch.cuda.memory_allocated() - before
    kv = sum(e.executor.cache_mgr.kv_bytes for e in router.engines)
    if not kv <= grew < kv + 0.01 * weights:
        raise SmokeError(f"[engine] (d) the router allocated {grew / 1e9:.3f} GB: two KV pools "
                         f"are {kv / 1e9:.3f} GB, the weights {weights / 1e9:.3f} GB")
    per = _launches_per_call(base)
    launched = dict(LAUNCHES)
    scans = [e.executor._decode_scan for e in router.engines]
    calls = [0, 0]
    for i, e in enumerate(router.engines):
        def counted(*a, i=i, **k):
            calls[i] += 1
            return scans[i](*a, **k)
        e.executor._decode_scan = counted
    handles = [router.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
    fin = router.generate()
    for e in router.engines:
        del e.executor._decode_scan
    streams = [fin[h.uid].generated for h in handles]
    tel = router.telemetry
    admitted = [t["prompts_admitted"] for t in tel["replica_telemetry"]]
    if admitted != [len(prompts) // 2] * 2:
        raise SmokeError(f"[engine] (d) admitted per replica {admitted}")
    steps = sum(calls) * SERVE_SC["decode_steps"]
    want = {k: per["prefill"][k] * tel["prefill_dispatches"] + per["decode"][k] * steps
            for k in per["prefill"]}
    got = {k: LAUNCHES.get(k, 0) - launched.get(k, 0) for k in per["prefill"]}
    if got != want:
        raise SmokeError(f"[engine] (d) launches {got}, expected {want}")
    close = _same_streams("[engine] (d) router vs one engine", streams, ref, base, params,
                          prompts, dev)
    del router
    torch.cuda.empty_cache()
    log(f"[engine] (d) router, 2 replicas on one card: admitted {admitted}, streams equal one "
        f"engine's (close calls {close or 'none'}); allocation grew {grew / 1e9:.3f} GB = the "
        f"two KV pools ({kv / 1e9:.3f} GB), not a second copy of the {weights / 1e9:.3f} GB of "
        f"weights; launches {got}")
    return dict(admitted=admitted, alloc_gb=grew / 1e9, kv_gb=kv / 1e9,
                weights_gb=weights / 1e9, launches=got, close_calls=close)


def _engine_shard(base, params, prompts, ref, dev) -> dict:
    """(e): ``shard_decode`` in a one-card NCCL process group: params and
    pools DTensors, the engine on their local tensors, one engine's
    streams, one decode shape."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ServeConfig
    from repro_torch.serve.api import Engine

    work = Path(tempfile.mkdtemp(prefix="shard_", dir=ROOT / "build"))
    dist.init_process_group("nccl", init_method=f"file://{work / 'pg'}", rank=0, world_size=1)
    try:
        eng = Engine(base, params, ServeConfig(**SERVE_SC, shard_decode=True), device=dev)
        ex = eng.executor
        leaves = [t for _, t in _leaves(ex.placed["params"])] + [
            t for g in ex.placed["caches"].values() for t in g.values()]
        if not all(isinstance(t, DTensor) for t in leaves):
            raise SmokeError("[engine] (e) a parameter or cache pool is not a DTensor")
        streams, metrics, decodes, grew, _ = _checked_engine_run(
            eng, prompts, SERVE_NEW, "[engine] (e) shard_decode")
        tel = eng.telemetry
        if tel["decode_compiles"] != 1:
            raise SmokeError(f"[engine] (e) {tel['decode_compiles']} decode shapes")
        close = _same_streams("[engine] (e) shard_decode vs unsharded", streams, ref, base,
                              params, prompts, dev)
        log(f"[engine] (e) shard_decode on a one-card mesh (NCCL, world 1): {len(leaves)} "
            f"DTensors (params and pools), streams equal the unsharded engine's (close calls "
            f"{close or 'none'}), 1 decode shape, {metrics['tokens_per_s']:.1f} output tokens/s")
        del eng, ex, leaves
        torch.cuda.empty_cache()
        return dict(metrics, dtensors=True, decode_compiles=1, launches=grew, close_calls=close)
    finally:
        dist.barrier()
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)


SHARD_RANKS = 2  # (g): shard_decode over two gloo ranks on the one card (NCCL refuses that)
#: (g)'s runs: (model dtype, layout).  bf16 is held bitwise against the
#: one-rank engine whose decode runs at a rank's shape (max_batch / 2
#: slots): cuBLAS rounds a bf16 decode at 4 rows otherwise than at 8.
#: float32 (2 layers) against the one-rank engine at all 8 slots.
SHARD_REQUESTS = SERVE_SHARED_REQUESTS  # (g) serves phase 7's first 8 prompts (the shared prefix)
SHARD_RUNS = (("bfloat16", {}),
              ("bfloat16", dict(kv_layout="paged", kv_page_size=16, kv_prefix_cache=True)),
              ("float32", {}))


def _shard_rank(rank: int, world: int, work: str, ref) -> None:
    """One of (g)'s two processes: rank 0 serves phase 7's first
    ``SHARD_REQUESTS`` prompts through
    ``Engine`` under ``shard_decode`` for each of ``SHARD_RUNS``, with phase
    7's launch and program checks, its streams bitwise the one-rank
    engine's (module docstring, 13), and where the bf16 streams part from
    the 8-slot one-rank engine's ``ref``, the direct loop's margins; rank 1
    runs ``serve_worker``.  Each writes ``rank<rank>.json`` under
    ``work``: its slots and program shapes."""
    import datetime

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.models import lm
    from repro_torch.serve.api import Engine, serve_worker

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{work}/pg", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        runs, models = [], {}
        for dtype, layout in SHARD_RUNS:
            if dtype not in models:
                cut = (dict(n_layers=GRANITE_SERVE_LAYERS) if dtype == "bfloat16"
                       else dict(n_layers=TP_CUT["n_layers"], dtype=dtype))
                base = dataclasses.replace(get_config("granite-8b"), **cut)
                models = {dtype: (base, lm.init_params(
                    base, torch.Generator(device=dev).manual_seed(SEED), device=dev))}
            base, params = models[dtype]
            prompts = _serve_traffic(base)[:SHARD_REQUESTS]
            sc = ServeConfig(**SERVE_SC, **layout, shard_decode=True)
            label = (f"[engine] (g) shard_decode over {world} ranks, {base.n_layers} L {dtype} "
                     f"{sc.kv_layout}{' + prefix cache' if sc.kv_prefix_cache else ''}")
            rec = dict(run=label.split(", ", 1)[1])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                if rank == 0:
                    slots = SERVE_SC["max_batch"] // world if dtype == "bfloat16" else None
                    one = ServeConfig(**dict(SERVE_SC, max_batch=slots or SERVE_SC["max_batch"]),
                                      **layout)
                    want = _run_engine(Engine(base, params, one, device=dev), prompts,
                                       SERVE_NEW)[0]
                    eng = Engine(base, params, sc, device=dev)
                    ex = eng.executor
                    streams, metrics, decodes, grew, _ = _checked_engine_run(
                        eng, prompts, SERVE_NEW, label)
                    eng.close()
                    if streams != want:
                        raise SmokeError(f"{label}: rank 0's streams differ from the one-rank "
                                         f"engine's at {one.max_batch} slots")
                    rec.update(metrics, launches=grew, decode_dispatches=decodes,
                               one_rank_slots=one.max_batch)
                    if dtype == "bfloat16" and not layout:
                        parted = [(i, next(k for k in range(len(b)) if a[k] != b[k]))
                                  for i, (a, b) in enumerate(zip(streams, ref)) if a != b]
                        rec["vs_8_slots"] = [dict(request=i, step=k, margin=float(
                            _direct_greedy(base, params, prompts[i], k + 1, dev)[1][k]))
                            for i, k in parted]
                    del eng
                else:
                    ex = serve_worker(base, params, sc, device=dev)
            rec.update(slots=[ex.shard.lo, ex.shard.hi], split=ex.shard.split,
                       decode_shapes=sorted(ex._decode_shapes),
                       prefill_shapes=sorted(ex._prefill_shapes))
            if rec["decode_shapes"] != [(ex.shard.hi - ex.shard.lo, sc.decode_steps)]:
                raise SmokeError(f"{label}: rank {rank} ran decode shapes {rec['decode_shapes']}")
            runs.append(rec)
            del ex
            torch.cuda.empty_cache()
        Path(work, f"rank{rank}.json").write_text(json.dumps(runs, default=str))
        dist.barrier()  # a gloo rank that leaves early resets its peer
    finally:
        dist.destroy_process_group()


def _engine_shard_ranks(ref, smi) -> dict:
    """(g): ``shard_decode`` over two gloo ranks on the one card (module
    docstring, 13)."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    work = Path(tempfile.mkdtemp(prefix="shard_ranks_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        mp.spawn(_shard_rank, args=(SHARD_RANKS, str(work), ref[:SHARD_REQUESTS]),
                 nprocs=SHARD_RANKS, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(SHARD_RANKS)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for k, rec in enumerate(ranks[0]):
        parted = rec.get("vs_8_slots")
        log(f"[engine] (g) shard_decode over {SHARD_RANKS} gloo ranks on the card, "
            f"{rec['run']}: slots {[r[k]['slots'] for r in ranks]}, decode shapes "
            f"{[r[k]['decode_shapes'] for r in ranks]}, streams bitwise the one-rank engine's "
            f"at {rec['one_rank_slots']} slots, launches {rec['launches']}; "
            f"{rec['tokens_per_s']:.1f} output tokens/s, TTFT p50 {rec['ttft_ms_p50']:.0f} ms, "
            f"ITL p50 {rec['itl_ms_p50']:.2f} ms ({smi})"
            + ("" if parted is None else
               f"; against the 8-slot engine {len(parted)} of {rec['requests']} requests part "
               f"(bf16 rounds a 4-row decode otherwise), direct-loop margins "
               f"{sorted(round(p['margin'], 4) for p in parted)}"))
    return dict(ranks=ranks, spawn_s=spawn_s)


def _engine_pallas_row(base, params, dev) -> dict:
    """(f): chunking, prefix-skip, preemption resume and speculative decoding
    asked for on the card: the prefill attends through the kernel, so
    ``cache_extend`` is False and each is disabled with the reference's
    RuntimeWarning, and the engine still serves; the same ServeConfig
    (int8_serve, whose decode is not bitwise its prefill, so chunk tails
    take the extend program) on the port's CPU engine, over reduced
    granite-8b, honors every one."""
    import torch

    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.models import lm
    from repro_torch.serve.api import Engine

    sc = ServeConfig(**ENGINE_PALLAS_SC)
    out = {}
    cpu_cfg = get_config("granite-8b", reduced=True)
    for where, cfg, p, d in (("card", base, params, dev),
                             ("cpu", cpu_cfg, None, torch.device("cpu"))):
        if p is None:
            p = lm.init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = Engine(cfg, p, sc, device=d)
        warned = [str(w.message) for w in caught if w.category is RuntimeWarning]
        prompts = _serve_prompts(3, SERVE_CHECK[0][2], 32, 3, cfg.vocab_size)
        streams, _ = _run_engine(eng, prompts, SERVE_CHECK_NEW)
        tel = eng.telemetry
        out[where] = dict(cache_extend=eng.executor.cache_extend,
                          disabled=tel["disabled_features"], warnings=warned,
                          extend_dispatches=tel["extend_dispatches"],
                          draft_tokens_proposed=tel["draft_tokens_proposed"],
                          tokens=sum(len(s) for s in streams))
        del eng
    card, cpu = out["card"], out["cpu"]
    joined = " ".join(card["disabled"])
    missing = [f for f in ENGINE_PALLAS_DISABLED if f not in joined]
    if card["cache_extend"] or missing or not card["warnings"] or not card["tokens"]:
        raise SmokeError(f"[engine] (f) on the card: cache_extend {card['cache_extend']}, "
                         f"not named disabled {missing}, warnings {len(card['warnings'])}")
    if cpu["disabled"] or cpu["extend_dispatches"] <= 0 or cpu["draft_tokens_proposed"] <= 0:
        raise SmokeError(f"[engine] (f) on the CPU: {cpu}")
    log(f"[engine] (f) the reference's Pallas row: on the card cache_extend False, disabled "
        f"{[d.split(':')[0] for d in card['disabled']]}, {len(card['warnings'])} RuntimeWarnings, "
        f"{card['tokens']} tokens served; the same ServeConfig on the CPU engine: nothing "
        f"disabled, {cpu['extend_dispatches']} extend dispatches, "
        f"{cpu['draft_tokens_proposed']} draft tokens proposed")
    return out


def phase_engine(dev):
    """Phase 13: the rest of the serving engine on the card (module
    docstring, 13).  Returns (results, launch counts of the window)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    LAUNCHES.clear()  # the engine path's window starts here
    torch.cuda.empty_cache()
    base = dataclasses.replace(get_config("granite-8b"), n_layers=GRANITE_SERVE_LAYERS)
    params = lm.init_params(base, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompts = _serve_traffic(base)
    t0 = time.perf_counter()
    res = {}
    res["async"], ref = _engine_async(base, params, prompts, dev, smi)
    secs = {"async": time.perf_counter() - t0}
    log(f"[engine] (async: {secs['async']:.1f} s)")
    for key, fn, args in (("nbest", _engine_nbest, (base, params, prompts, ref, dev)),
                          ("tier", _engine_tier, (base, params, prompts, dev, smi)),
                          ("router", _engine_router, (base, params, prompts, ref, dev)),
                          ("shard", _engine_shard, (base, params, prompts, ref, dev)),
                          ("shard_ranks", _engine_shard_ranks, (ref, smi)),
                          ("pallas_row", _engine_pallas_row, (base, params, dev))):
        t1 = time.perf_counter()
        res[key] = fn(*args)
        secs[key] = time.perf_counter() - t1
        log(f"[engine] ({key}: {secs[key]:.1f} s)")
    del params
    torch.cuda.empty_cache()
    counts = dict(LAUNCHES)  # the engine path's window ends here
    for kname in ("flash_attention", "layernorm"):
        if counts.get(kname, 0) <= 0:
            raise SmokeError(f"{kname} was never launched on the engine path")
    log(f"[engine] engine path launches: {counts}; seconds "
        f"{ {k: round(v, 1) for k, v in secs.items()} }")
    return dict(res, seconds=secs, nvidia_smi=smi), counts


# ------------------------------------------------------------------ tp --

TP_RANKS, TP_MESH = 2, (1, 2)  # two processes on the one card, gloo: NCCL refuses that
TP_DATA_MESH = (2, 1)  # the data-sharded MoE step: the two ranks split the batch
TP_CUT = dict(n_layers=2, dtype="float32")  # zamba2-1.2b: its layer 0 applies the shared block
TP_TRAIN = ("granite-8b", "granite-moe-3b-a800m", "minicpm3-4b", "zamba2-1.2b", "hubert-xlarge",
            "internvl2-1b")
TP_MOE_DATA = "granite-moe-3b-a800m"  # on TP_DATA_MESH against the whole-batch step
TP_BATCH = (2, 2048)
TP_STEPS = 2
TP_LR = 3e-4
TP_LOSS_TOL = 1e-4
TP_STATE_TOL = 1e-5  # parameters: of max(1, |x|)
TP_MOMENT_TOL = 1e-4  # moments: of the leaf's largest |x| (float32 rounding reaches 1.1e-5)
TP_ADAM_RESIDUAL = 1e-6  # of max(1, |x|): a parameter's part not explained by its moments
TP_ADAM_SHARE = 1e-4  # the most parameters whose normalised update amplifies rounding
TP_DECODE = (1, 2048, 8)  # granite-8b, minicpm3-4b bf16 2 layers: batch, prompt, greedy steps
#: "<arch>" or "<arch>:<precision policy>"
TP_DECODE_MODELS = ("granite-8b", "minicpm3-4b", "internvl2-1b", "granite-8b:int8_serve")
TP_VLM_PROMPT = 256  # internvl2-1b's text tokens after its 256 patches
TP_MARGIN = 5e-2  # bf16: a greedy token may part only where the unsharded top-two margin is less
TP_ATTENTION = (2, 16, 2048, 128)  # granite-8b's attend at model 2: batch, q heads, tokens, d
TP_KV_HEADS = 4
TP_NORM = (4096, 4096)  # the norms' rows (2 x 2048 tokens) at d_model, RMS
TP_MLA_ATTENTION = (8, 20, 2048, 96)  # minicpm3-4b's attend at model 2: 20 of 40 heads, V at 64
TP_MLA_V = 64
TP_SSD = (2, 2048, 32, 64, 64)  # zamba2's scan at model 2: batch, tokens, 32 of 64 heads, P, N
TP_HUBERT_ATTENTION = (8, 8, 512, 80)  # hubert-xlarge at model 2: 8 of 16 heads, both ways
TP_VLM_ATTENTION = (8, 7, 2048, 64)  # internvl2-1b at model 2: 7 of 14 q heads, causal
TP_VLM_KV_HEADS = 1  # and 1 of its 2 kv heads


def _tp_local_cases(dev) -> list[dict]:
    """Phase 2's cases at the split's local shapes: granite-8b's attend at
    model 2 (16 of 32 q heads, 4 of 8 kv heads) forward and backward in
    float32 and bf16, and its RMSNorm rows; minicpm3-4b's attend at model
    2 (20 of 40 heads, q/k at 96, V at 64) in bf16, SDPA beside it;
    zamba2-1.2b's scan at model 2 (32 of 64 SSM heads) forward and
    backward in float32; hubert-xlarge's attend at model 2 (8 of 16 heads
    of 80, both ways, padded to the 128 instance) and internvl2-1b's (7 of
    14 q heads over 1 of 2 kv heads, causal) in bf16, SDPA beside them."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        cases.append(_attention_case(dev, TP_ATTENTION, "safe", causal=True, dtype=dtype,
                                     hkv=TP_KV_HEADS))
        cases.append(_attention_grad_case(dev, TP_ATTENTION, TP_KV_HEADS, True, None, None, dtype,
                                          "safe"))
    cases.append(_layernorm_case(dev, *TP_NORM, True, False))
    cases.append(_layernorm_grad_case(dev, *TP_NORM, True, False))
    cases.append(_attention_case(dev, TP_MLA_ATTENTION, "safe", causal=True, dtype="bfloat16",
                                 v_dim=TP_MLA_V))
    b, l, h, p, n = TP_SSD
    cases.append(_ssd_case(dev, b, l, h, p, n, 1, 64))
    cases.append(_ssd_grad_case(dev, b, l, h, p, n, 1, "float32"))
    cases.append(_attention_case(dev, TP_HUBERT_ATTENTION, "safe", causal=False, dtype="bfloat16"))
    cases.append(_attention_case(dev, TP_VLM_ATTENTION, "safe", causal=True, dtype="bfloat16",
                                 hkv=TP_VLM_KV_HEADS))
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SmokeError(f"{len(bad)} local-shape kernel cases failed: {bad}")
    return cases


def _tp_shard(state, shardings, mesh):
    """``state`` (whole, on this rank) as DTensors under ``shardings``:
    each rank's shard cut locally and copied, so the whole state stays as
    it is."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import map_tree, shard_of

    return map_tree(lambda t, sh: DTensor.from_local(
        shard_of(t, sh.placements, mesh).clone(), mesh, sh.placements, run_check=False),
        state, shardings)


def _tp_want(cfg, group, attends: bool) -> tuple[dict, tuple, int | None]:
    """(the launches one call of the split path makes, its attention's (q,
    kv) heads, its scan's heads) for ``cfg`` under ``group`` (None: the
    ``"repeat"`` pattern, whole heads).  ``layernorm``: each block's norms
    (a GQA or MoE block 2, an MLA block 4 with ``q_norm`` / ``kv_norm``, a
    Mamba2 block 2 with ``gate_norm``, each application of the hybrid's
    shared block 2) and the final norm.  ``flash_attention``: once per
    attention layer (the hybrid: per application) where the call
    ``attends`` (train, prefill; decode attends without it);
    ``ssd_scan`` once per Mamba2 layer likewise."""
    from repro_torch.distributed import tensor_parallel as tp_lib
    from repro_torch.models import lm

    L, apps = cfg.n_layers, lm.n_shared_apps(cfg)
    size = 1 if group is None else group.size
    heads = (cfg.n_heads, cfg.n_kv_heads)
    if group is not None and group.layout.heads:
        lo, hi = tp_lib.kv_head_range(cfg, group)
        heads = (cfg.n_heads // size, cfg.n_heads // size if cfg.attn_kind == "mla" else hi - lo)
    ssd_heads = None
    if cfg.ssm is not None:
        ssd_heads = cfg.ssm.n_heads(cfg.d_model)
        if group is not None and group.layout.ssm:
            ssd_heads //= size
    if cfg.family == "hybrid":
        ln, flash, ssd = 2 * L + 2 * apps + 1, apps, L
    elif cfg.family == "ssm":
        ln, flash, ssd = 2 * L + 1, 0, L
    else:
        ln, flash, ssd = (4 if cfg.attn_kind == "mla" else 2) * L + 1, L, 0
    want = {"layernorm": ln}
    if attends:
        want.update({k: n for k, n in (("flash_attention", flash), ("ssd_scan", ssd)) if n})
    return want, heads, ssd_heads


def _tp_split_call(fn, cfg, group, attends: bool):
    """``fn()``, one call of the split path, in a window of its own: the
    kernel counts set to 0 just before it and read just after, and the
    (q heads, kv heads) of every attention call and the heads of every scan
    recorded.  Raises unless the window launched what ``_tp_want`` says,
    every attention and scan at this rank's heads.  Returns (fn's result,
    the counts, the attention heads seen)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import attention, ssm

    real, real_ssd, heads, scans = attention.mha, ssm.ssd_with_state, [], []

    def recorded(q, k, v, **kw):
        heads.append((int(q.shape[1]), int(k.shape[1])))
        return real(q, k, v, **kw)

    def recorded_ssd(xdt, *a, **kw):
        scans.append(int(xdt.shape[2]))
        return real_ssd(xdt, *a, **kw)

    want, local, ssd_heads = _tp_want(cfg, group, attends)
    attention.mha, ssm.ssd_with_state = recorded, recorded_ssd
    LAUNCHES.clear()  # the window starts here
    try:
        out = fn()
    finally:
        attention.mha, ssm.ssd_with_state = real, real_ssd
    counts = {k: n for k, n in LAUNCHES.items() if n}
    LAUNCHES.clear()
    if (counts != want or heads != [local] * want.get("flash_attention", 0)
            or scans != [ssd_heads] * want.get("ssd_scan", 0)):
        raise SmokeError(f"[tp] {cfg.name}: the split call launched {counts} (want {want}) at "
                         f"(q, kv) heads {sorted(set(heads))} (want {local}), scans at heads "
                         f"{sorted(set(scans))} (want {ssd_heads})")
    return out, counts, local


def _tp_config(name, **cut):
    """The published config of ``name`` ("<arch>" or "<arch>:<precision
    policy>") with the fields ``cut``."""
    from repro_torch.configs import get_config

    arch, _, policy = name.partition(":")
    return dataclasses.replace(get_config(arch), **cut, **({"precision": policy} if policy
                                                           else {}))


def _tp_batch(cfg, g, dev) -> dict:
    """A ``TP_BATCH`` training batch of ``cfg``'s family from the CPU
    generator ``g``: frames and labels (the audio encoder), the VLM's
    patches before the rest of the sequence in tokens, or tokens."""
    import torch

    b, s = TP_BATCH
    fd = cfg.frontend_dim or cfg.d_model
    if cfg.frontend == "audio":
        return {"frames": torch.randn(b, s, fd, generator=g).to(dev),
                "labels": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                        dtype=torch.int32).to(dev)}
    n_img = cfg.n_frontend_tokens if cfg.frontend == "patch" else 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s - n_img), generator=g,
                                     dtype=torch.int32).to(dev)}
    if n_img:
        batch["patches"] = torch.randn(b, n_img, fd, generator=g).to(dev)
    return batch


def _tp_train(name, mesh, dev, pattern: str = "model") -> dict:
    """(a), (b), (d), (e), (g): ``TP_STEPS`` sharded steps of ``name`` at its
    published widths on ``mesh``, taking the ``pattern`` split, each from
    the state the unsharded step on the whole batch starts from on this
    rank, held against it."""
    import torch

    from repro_torch.configs import ParallelismConfig
    from repro_torch.distributed import ShardingRules
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_state, make_train_step, train_state_shardings

    cfg = _tp_config(name, **TP_CUT)
    rules = ShardingRules(mesh=mesh, plan=ParallelismConfig())
    opt = AdamW(schedule=lambda s: TP_LR)
    state = make_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    shardings = train_state_shardings(cfg, opt, rules)
    split, plain = make_train_step(cfg, opt, mesh=mesh, rules=rules), make_train_step(cfg, opt)
    if split.split != pattern:
        raise SmokeError(f"{name}: the sharded step's pattern is {split.split!r}, not {pattern!r}")
    group = split.keywords["group"]
    sent_by = group.bytes if group is not None else {}
    g = torch.Generator().manual_seed(SEED + 1)
    steps = []
    for i in range(TP_STEPS):
        batch = _tp_batch(cfg, g, dev)
        sharded = _tp_shard(state, shardings, mesh)
        rec = {}
        for kind, fn, st in (("split", split, sharded), ("plain", plain, state)):
            held = sum(t.to_local().numel() * t.to_local().element_size() if kind == "split"
                       else t.numel() * t.element_size() for _, t in _leaves(st))
            sent = dict(sent_by)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if kind == "split":
                (_, m), launches, heads = _tp_split_call(lambda: fn(st, batch), cfg, group, True)
            else:
                _, m = fn(st, batch)
            torch.cuda.synchronize()
            rec[kind] = dict(ms=(time.perf_counter() - t0) * 1e3,
                             state_gb=held / 1e9,
                             step_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                             metrics={k: float(v) for k, v in m.items()})
            if kind == "split":
                rec[kind].update(collective_bytes={k: sent_by[k] - sent[k] for k in sent},
                                 launches=launches, heads=heads)
        rec.update(_tp_state_check(sharded, state, shardings, mesh, opt))
        del sharded
        rec["loss_err"] = abs(rec["split"]["metrics"]["loss"] - rec["plain"]["metrics"]["loss"])
        steps.append(rec)
    del state
    torch.cuda.empty_cache()
    bad = [(i, rec) for i, rec in enumerate(steps) if rec["loss_err"] > TP_LOSS_TOL
           or not rec["state_ok"] or (cfg.moe is not None and (
               rec["split"]["metrics"]["moe_dropped_frac"]
               != rec["plain"]["metrics"]["moe_dropped_frac"]))]
    if bad:  # after every step, so that the message holds each step's readings
        raise SmokeError(f"[tp] {name}: steps {[i for i, _ in bad]} off (loss tol {TP_LOSS_TOL}, "
                         f"moments {TP_MOMENT_TOL}): " + "; ".join(
                             f"step {i}: " + str({k: v for k, v in rec.items()
                                                  if k not in ("split", "plain")})
                             + f" dropped {rec['split']['metrics'].get('moe_dropped_frac')} / "
                             f"{rec['plain']['metrics'].get('moe_dropped_frac')}"
                             for i, rec in enumerate(steps)))
    return dict(model=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, batch=list(TP_BATCH),
                mesh=list(mesh.shape), pattern=pattern, steps=steps)


def _tp_state_check(sharded, state, shardings, mesh, opt) -> dict:
    """The split step's shards against the same shards of the unsharded
    step's state, both from one state.  The moments (linear in the
    gradient) within ``TP_MOMENT_TOL`` of their leaf's largest magnitude,
    every element.  A parameter within ``TP_STATE_TOL`` of max(1, |x|), or,
    where AdamW's normalised update m / sqrt(v) amplifies the moments'
    rounding (a gradient at the rounding's size), at most ``TP_ADAM_SHARE``
    of them, its difference exactly what the two runs' moments give
    through that update: the rest within ``TP_ADAM_RESIDUAL``."""
    import torch

    from repro_torch.distributed.sharding import shard_of

    step = state["opt"]["step"]
    c1, c2 = 1 - opt.b1 ** step.float(), 1 - opt.b2 ** step.float()
    lr = float(opt.schedule(step))

    def update(m, v):  # AdamW's normalised update, as ``optim.adamw`` computes it
        return (m / c1) / (torch.sqrt(v / c2) + opt.eps)

    def mine(path):
        t = _leaf_at(sharded, path).to_local()
        return t, shard_of(_leaf_at(state, path), _leaf_at(shardings, path).placements, mesh)

    def rel(a, b):
        return (a.double() - b.double()).abs() / b.double().abs().clamp_min(1)

    def leaf_rel(a, b):
        return float((a.double() - b.double()).abs().max()) / max(float(b.abs().max()), 1e-30)

    moments, params, residual, amplified, n, worst_leaf = 0.0, 0.0, 0.0, 0, 0, None
    worst_moment = None
    for path, _ in _leaves(shardings["params"]):
        (mu_s, mu_u), (nu_s, nu_u) = mine("opt/mu/" + path), mine("opt/nu/" + path)
        m_err = max(leaf_rel(mu_s, mu_u), leaf_rel(nu_s, nu_u))
        if m_err > moments:
            moments, worst_moment = m_err, path
        p_s, p_u = mine("params/" + path)
        d = rel(p_s, p_u)
        if float(d.max()) > params:
            params, worst_leaf = float(d.max()), path
        over = d > TP_STATE_TOL
        if bool(over.any()):
            explained = lr * (update(mu_s, nu_s) - update(mu_u, nu_u)).double()
            left = (p_s.double() - p_u.double() + explained).abs() / p_u.double().abs().clamp_min(1)
            residual = max(residual, float(left[over].max()))
            amplified += int(over.sum())
        n += p_u.numel()
    ok = (moments <= TP_MOMENT_TOL and residual <= TP_ADAM_RESIDUAL
          and amplified <= TP_ADAM_SHARE * n)
    return dict(state_ok=ok, moments_rel_err=moments, moments_worst_leaf=worst_moment,
                params_rel_err=params, params_worst_leaf=worst_leaf, amplified=amplified,
                params_n=n,
                amplified_residual=residual)


def _leaf_at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _tp_decode(name, mesh, dev) -> dict:
    """(c), (f), (i), (j): ``name`` ("<arch>" or "<arch>:<precision
    policy>") in bf16, a prefill and greedy decode steps over this rank's
    caches (granite-8b's kv heads; minicpm3-4b's latent, whole; the VLM's
    patches before its prompt; under ``int8_serve`` the int8 KV cache and
    the LUT softmax, the weights the plan's transform of the whole leaves,
    cut after it), against the unsharded model on the unsharded run's
    tokens."""
    import torch

    from repro_torch.configs import ParallelismConfig
    from repro_torch.core import precision as precision_lib
    from repro_torch.distributed import ShardingRules
    from repro_torch.distributed import tensor_parallel as tp_lib
    from repro_torch.distributed.sharding import map_tree, param_shardings, shard_of
    from repro_torch.models import lm
    from repro_torch.train.step import model_split

    b, s0, steps = TP_DECODE
    cfg = _tp_config(name, n_layers=TP_CUT["n_layers"])
    plan = precision_lib.resolve_model_plan(cfg)
    rules = ShardingRules(mesh=mesh, plan=ParallelismConfig())
    params = precision_lib.apply_plan_to_params(
        lm.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev), plan)
    sh = param_shardings(rules, cfg, lm)
    group, local = model_split(cfg, mesh, sh)
    split = map_tree(lambda t, s, loc: shard_of(t, s.placements, mesh, ("model",)).clone()
                     if loc else t, params, sh, local)
    launches = collections.Counter()

    def split_call(fn, attends):
        out, counts, heads = _tp_split_call(fn, cfg, group, attends)
        launches.update(counts)
        return out
    g = torch.Generator().manual_seed(SEED + 2)
    prompt = {}
    if cfg.frontend == "patch":  # the image prefix, then TP_VLM_PROMPT text tokens
        s0 = TP_VLM_PROMPT
        prompt["patches"] = torch.randn(b, cfg.n_frontend_tokens, cfg.frontend_dim,
                                        generator=g).to(dev, torch.bfloat16)
    off = cfg.n_frontend_tokens if "patches" in prompt else 0
    prompt["tokens"] = torch.randint(0, cfg.vocab_size, (b, s0), generator=g,
                                     dtype=torch.int32).to(dev)
    max_len = off + s0 + steps
    quant = plan.int8_kv_cache

    def caches():
        return lm.init_caches(cfg, b, max_len, torch.bfloat16, quantized=quant, device=dev)
    whole = caches()
    mine = {g2: {k: t.clone() for k, t in leaves.items()}
            for g2, leaves in tp_lib.local_caches(cfg, caches(), group).items()}
    s_last, mine = split_call(lambda: lm.prefill(split, cfg, prompt, mine, device=dev,
                                                 group=group), True)
    w_last, whole = lm.prefill(params, cfg, prompt, whole, device=dev)
    errs, close, toks = [float((s_last.float() - w_last.float()).abs().max())], [], []
    for k in range(steps + 1):
        top2 = w_last.float().topk(2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        if not torch.equal(s_last.argmax(-1), w_last.argmax(-1)):
            if margin >= TP_MARGIN:
                raise SmokeError(f"[tp] {name} bf16 decode step {k}: the split's greedy "
                                 f"token differs where the unsharded margin is {margin:.3e}")
            close.append(dict(step=k, margin=margin))
        if k == steps:
            break
        tok = w_last.argmax(-1, keepdim=True)  # both runs take the unsharded run's tokens
        toks.append(tok)
        pos = torch.full((b,), off + s0 + k, dtype=torch.int32, device=dev)
        s_last, mine = split_call(lambda: lm.decode_step(split, cfg, tok, pos, mine, device=dev,
                                                         group=group), False)
        w_last, whole = lm.decode_step(params, cfg, tok, pos, whole, device=dev)
        errs.append(float((s_last.float() - w_last.float()).abs().max()))
    if cfg.attn_kind == "mla":  # the latent is the heads', whole on every rank
        heads, width = cfg.n_heads // group.size, int(mine["layers"]["latent"].shape[-1])
        if width != cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim:
            raise SmokeError(f"[tp] {name}: the split latent cache holds {width} columns")
    else:
        heads = int(mine["layers"]["k"].shape[2])
        if heads != cfg.n_kv_heads // group.size:
            raise SmokeError(f"[tp] {name}: the split caches hold {heads} kv heads")
        if quant and (mine["layers"]["k"].dtype != torch.int8
                      or int(mine["layers"]["k_scale"].shape[2]) != heads):
            raise SmokeError(f"[tp] {name}: the split int8 KV cache is not narrowed by kv head")
    return dict(model=cfg.name, policy=plan.policy.name, layers=cfg.n_layers, dtype=cfg.dtype,
                batch=b, prompt=s0, image=off, steps=steps, cache_kv_heads=heads,
                int8_kv=bool(quant), launches=dict(launches), max_abs_logit_err=errs,
                logit_scale=float(w_last[..., :cfg.vocab_size].float().abs().max()),
                close_calls=close,
                tokens=torch.cat(toks, 1).cpu().tolist())


def _tp_rank(rank: int, world: int, work: str) -> None:
    """One of the phase's two processes: a (data 1, model 2) mesh over gloo
    on the one card; writes ``rank<rank>.json`` under ``work``."""
    import datetime

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{work}/pg", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(TP_MESH, ("data", "model"), device_type="cuda")
        data_mesh = make_mesh(TP_DATA_MESH, ("data", "model"), device_type="cuda")
        t0 = time.perf_counter()
        out = {"train": [_tp_train(name, mesh, dev) for name in TP_TRAIN]
               + [_tp_train(TP_MOE_DATA, data_mesh, dev, pattern="repeat")],
               "decode": [_tp_decode(name, mesh, dev) for name in TP_DECODE_MODELS]}
        out["seconds"] = time.perf_counter() - t0
        Path(work, f"rank{rank}.json").write_text(json.dumps(out, default=str))
        dist.barrier()  # a gloo rank that leaves early resets its peer
    finally:
        dist.destroy_process_group()


def phase_tp(dev):
    """Phase 14: the step split over the model axis (module docstring, 14).
    Returns (results, the launch counts of the split calls' windows, both
    ranks: the unsharded runs they are held against count nothing)."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    cases = _tp_local_cases(dev)
    _report_cases([c for c in cases if "ms" in c])
    for c in cases:
        if "fwd_bwd_ms" in c:
            log(f"[tp] grad {c['kernel']} {c['shape']} {c.get('dtype', 'float32')}: max |d| "
                f"{c['max_abs_err']}  fwd+bwd {c['fwd_bwd_ms']:.3f} ms (plain "
                f"{c['plain_fwd_bwd_ms']:.3f})")
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="tp_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        mp.spawn(_tp_rank, args=(TP_RANKS, str(work)), nprocs=TP_RANKS, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(TP_RANKS)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    counts = collections.Counter()
    for r in ranks:  # each split call's window held its counts (_tp_split_call)
        for t in r["train"]:
            for st in t["steps"]:
                counts.update(st["split"]["launches"])
        for d in r["decode"]:
            counts.update(d["launches"])
    for i, r in enumerate(ranks):
        for t in r["train"]:
            for k, st in enumerate(t["steps"]):
                sp, pl = st["split"], st["plain"]
                log(f"[tp] rank {i} {t['model']} {t['layers']} L {t['dtype']} {t['batch']} on "
                    f"{t['mesh']} ({t['pattern']}) step {k}: loss {sp['metrics']['loss']:.6f} "
                    f"(unsharded "
                    f"{pl['metrics']['loss']:.6f}, |d| {st['loss_err']:.2e}); launches "
                    f"{sp['launches']} at (q, kv) heads {sp['heads']}; moments |d| / leaf max "
                    f"{st['moments_rel_err']:.2e} ({st['moments_worst_leaf']}); parameters "
                    f"|d| / max(1, |x|) {st['params_rel_err']:.2e} "
                    f"({st['params_worst_leaf']}; {st['amplified']} of {st['params_n']} over "
                    f"{TP_STATE_TOL} where m / sqrt(v) amplifies, all but "
                    f"{st['amplified_residual']:.1e} from the moments); state "
                    f"{sp['state_gb']:.2f} GB + step peak "
                    f"{sp['step_peak_gb']:.2f} GB (unsharded {pl['state_gb']:.2f} + "
                    f"{pl['step_peak_gb']:.2f}); step {sp['ms']:.1f} ms (unsharded "
                    f"{pl['ms']:.1f}; two ranks share the card: not a TP speed); collectives "
                    f"{ {k2: int(v) for k2, v in sp['collective_bytes'].items()} } B"
                    + (f"; dropped {sp['metrics']['moe_dropped_frac']} (unsharded "
                       f"{pl['metrics']['moe_dropped_frac']}), aux "
                       f"{sp['metrics']['moe_aux_loss']:.6e} (unsharded "
                       f"{pl['metrics']['moe_aux_loss']:.6e})"
                       if "moe_dropped_frac" in sp["metrics"] else ""))
        for d in r["decode"]:
            image = f" ({d['image']} patches)" if d["image"] else ""
            log(f"[tp] rank {i} {d['model']} {d['policy']} {d['layers']} L bf16 prefill "
                f"{d['batch']} x {d['image'] + d['prompt']}{image}"
                f" + {d['steps']} greedy steps at {d['cache_kv_heads']} "
                f"{'heads over the whole latent' if 'minicpm3' in d['model'] else 'kv heads'}"
                f"{' (int8 KV)' if d['int8_kv'] else ''} "
                f"(launches {d['launches']}): max |logit d| {max(d['max_abs_logit_err']):.3e} "
                f"(|logit| up to {d['logit_scale']:.2f}), close calls {d['close_calls']}")
    log(f"[tp] split calls' launches (both ranks): {dict(counts)}; ranks' seconds "
        f"{[round(r['seconds'], 1) for r in ranks]}, spawn to join {spawn_s:.1f} s")
    return dict(kernels=cases, ranks=ranks, spawn_s=spawn_s), dict(counts)


# ---------------------------------------------------------------- main --

def main() -> int:
    # phase 8 trains under torch.use_deterministic_algorithms(True), which
    # needs cuBLAS's fixed workspace configuration from the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is missing ({SRC / 'repro_torch'}); run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import resolve_device

    t_start = time.perf_counter()
    try:
        dev = resolve_device("cuda")
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
        log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
            f"cuda {torch.version.cuda} device {kind}")
        phase_s = {}

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            phase_s[name] = time.perf_counter() - t0
            log(f"[phase] {name}: {phase_s[name]:.1f} s")
            return out

        build_s, sass = timed("build", phase_build)
        cases = timed("kernels", phase_kernels, dev)
        models, model_counts = timed("models", phase_models, dev)
        mha, mha_counts = timed("mha", phase_mha, dev)
        softmax_path, softmax_counts = timed("lut_softmax", phase_lut_softmax_path, dev)
        mamba, mamba_counts = timed("mamba", phase_mamba, dev)
        dense, dense_counts = timed("dense", phase_dense, dev)
        serve, serve_counts = timed("serve", phase_serve, dev)
        train, train_counts = timed("train", phase_train, dev)
        int8, int8_counts = timed("int8_moe", phase_int8_moe, dev, serve["runs"])
        mla, mla_counts = timed("mla", phase_mla, dev)
        families, families_counts = timed("families", phase_families, dev)
        roofline, roofline_counts = timed("roofline", phase_roofline, dev, dict(
            models=models, mamba=mamba, dense=dense, int8_moe=int8, mla=mla, families=families))
        engine, engine_counts = timed("engine", phase_engine, dev)
        tp, tp_counts = timed("tp", phase_tp, dev)
    except Exception:  # noqa: BLE001 - report every failed phase and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    # launches: each kernel's count summed over the path windows it runs in
    windows = (model_counts, mha_counts, softmax_counts, mamba_counts, dense_counts, serve_counts,
               train_counts, int8_counts, mla_counts, families_counts, roofline_counts,
               engine_counts, tp_counts)
    counts = {k: sum(w.get(k, 0) for w in windows)
              for k in ("flash_attention", "layernorm", "qmatmul", "lut_softmax", "ssd_scan")}
    main_shape = {"flash_attention": ([8192, 4, 100, 8], "safe"),
                  "layernorm": ([8192 * 100, 32], "ln"),
                  "qmatmul": ([8192 * 100, 32, 32], "R=1"),
                  "lut_softmax": ([8192 * 4 * 100, 100], "none"),
                  "ssd_scan": ([192, 2048, 64, 128], "q64 g1")}
    sources = {k: f"src/repro_torch/csrc/{k}.cu" for k in main_shape}
    replaces = {"flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:154",
                "layernorm": "src/repro/kernels/layernorm/layernorm.py:69",
                "qmatmul": "src/repro/kernels/qmatmul/qmatmul.py:56",
                "lut_softmax": "src/repro/kernels/lut_softmax/lut_softmax.py:67",
                "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:87"}
    line = []
    for kname, (shape, mode) in main_shape.items():
        c = next(c for c in cases if c["kernel"] == kname and c["shape"] == shape
                 and c["mode"] == mode and c.get("dtype", "float32") in ("float32", "int8"))
        line.append({"name": kname, "route": "cuda", "source": sources[kname],
                     "replaces": replaces[kname], "launches": counts[kname],
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
                     "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"]})
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"device": kind, "nvidia_smi": smi, "build_s": build_s,
                               "sass_tensor_core_instructions": sass,
                               "kernels": cases, "models": models, "mha": mha,
                               "lut_softmax_path": softmax_path, "mamba": mamba,
                               "dense": dense, "serve": serve, "train": train,
                               "int8_moe": int8, "mla": mla, "families": families,
                               "roofline": roofline, "engine": engine, "tp": tp,
                               "launches": counts,
                               "launches_by_path": {"models": model_counts, "mha": mha_counts,
                                                    "lut_softmax": softmax_counts,
                                                    "mamba": mamba_counts,
                                                    "dense": dense_counts,
                                                    "serve": serve_counts,
                                                    "train": train_counts,
                                                    "int8_moe": int8_counts,
                                                    "mla": mla_counts,
                                                    "families": families_counts,
                                                    "roofline": roofline_counts,
                                                    "engine": engine_counts,
                                                    "tp": tp_counts},
                               "phase_seconds": phase_s,
                               "seconds": time.perf_counter() - t_start}, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s; details in {OUT.relative_to(ROOT)}")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
