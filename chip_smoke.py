#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits nonzero, no result):

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   build of the kernel library from src/repro_torch/csrc, with ptxas's
   registers and spills and each attention and SSD kernel's tensor-core
   instructions in the library's SASS (the bf16 B4, B5 and B6 must have
   some, their float32 versions none; B8's three product kernels some at
   N = 64 and 128);
2. every CUDA kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged small shapes, with its time, the plain
   version's time, its bound and, where one exists, a PyTorch call's time;
   B1 also bit-equal to its plain version (U * P not a multiple of 4, P
   below 4, one user); B2's fused candidate build (topk_candidates_kernel)
   with cand_idx equal and cand_q bit-equal to topk_candidates_ref and two
   calls bit-equal at one user, k < M, k = M, -1 padding with a service
   that has no implementation, QoS ties, a table larger than a block's
   shared memory and the main path's [10^6, 10],
   and its device time; the pre-gathered qos_candidates_kernel held too;
   for B3 also its device time alone and torch.max's (torch.profiler);
3. the main path at full size: a 1,000,000-user, 1,000-edge instance
   through evaluate_sparse (kernels) and Router.route (dense QoS kernel +
   OMS), with launch counts; then the same tick with the plain versions
   (same x), a second kernel tick (bit-identical), σ against a float64
   host evaluation, the candidate build's host and device time (one
   launch, no other device kernel), and the greedy loop's device time by
   kernel (B3's share);
4. the routed value against the sparse σ;
5. paper-scale instances against the host oracle: the sparse tick and
   Router.place with EGP, AGP and OPT (within 1e-4 of egp_np, agp_np,
   opt_np; EGP's ratio to OPT logged); then the dense batched path: the
   reference benchmark's mixed-size batch at 10,000 users through
   evaluate_batch, bucketed and padded, EGP and AGP, within 1e-4 of the
   host, x identical with the plain versions and on a rerun, B1 and B3
   launched;
6. the attention kernels (flash-attention forward B4, GQA decode B7)
   against their plain versions in float32 and bfloat16: at the serving
   path's shapes, at gemma2's head width with a window and a softcap, with
   ragged lengths, and in ring mode, with their times, bounds, achieved
   TFLOP/s and the time of torch's scaled_dot_product_attention on the
   same inputs; B7 also at the edges of its split-KV plan (empty and
   one-slot splits, a narrow window, ring past an Sc that is no multiple
   of 64, G = 5 and 8), two calls bit-equal, and its device time and
   SDPA's (torch.profiler) at the smollm and zamba2 serving shapes; both
   also at the MoE family's serving shapes (hd 128, G = 4 and 16) and at
   the smoke configs' hd = 16 (the edge cluster's), with their times,
   bounds and SDPA's;
7. serving at full width: smollm-360m (32 layers, d=960, 15/5 heads,
   49,152-token vocabulary, random weights from a seed) generates 32
   tokens for 8 prompts of 1,024 tokens through ModelServer, with launch
   counts (B4 once per layer per prefill, B7 once per layer per step);
   then, teacher-forced on those tokens, every attention call of the
   bf16 model is held against its plain version on its own inputs
   (within 2 bf16 ulps), the bf16 logits against the plain model's
   (within max abs and rms limits that controls with one coarsened layer
   exceed), and
   the same weights in float32 compute must give the plain attention's
   logits within 1e-4;
8. the SSD scan kernel (B8) against both plain versions (the sequential
   recurrence and the chunked scan) in float32 at the mamba2 and zamba2
   serving shapes and at a ragged shape with an initial state, within
   3e-4 of the reference's largest value, each launch's scratch (C·Bᵀ,
   chunk states, entering states) against the plain chunked scan's
   intermediates, two calls bit-equal, with its time, the plain versions'
   times, its float32 bound and the bound of the work its tensor-core
   plan runs; the same at the smoke configs' P = N = 16 (chunk 8, the
   float32 small-head launches);
9. serving mamba2-2.7b at its published widths and full depth (64 Mamba2
   layers, d=2560, 80 heads x 64, N=128, 50,280-token vocabulary) as
   phase 7 does: B8 once per layer per prefill and never in a decode step,
   every B8 call of the teacher-forced run held against the plain scan
   on its own inputs, the bf16 logits within limits that controls (layer
   0's SSD output at 2 and 6 mantissa bits) exceed, float32 logits within
   1e-4;
10. serving zamba2-2.7b at its published widths and full depth (54 Mamba2
   layers, N=64, two shared attention blocks applied 9 times at hd=80) the
   same way, with B8 54, B4 9 and B7 9 x 32 launches per generate and
   every B4/B7/B8 call held against its plain version;
11. the flash-attention backward kernels (B5 dQ, B6 dK/dV) against their
   plain version in float32 and bfloat16 at the training shape, at hd=80
   with G=1, with a sliding window, at a ragged length and non-causal,
   and at the training families' shapes (BWD_FAMILY_CASES: gemma2's
   softcap of 50 at its 32/16 heads x 128 with a window below Sq, hd = 16
   at phase 6's smoke shapes, qwen3-moe's G = 16 at hd 128, internvl2's
   G = 7 at hd 64), in float32 also against torch's autograd through the
   plain attention; a control drops the softcap's factor 1 - t^2 from the
   plain version and must fail the gate in both dtypes; with their times,
   bounds, achieved TFLOP/s, the plain version's time and, where it
   computes the same function (no softcap, no window), the backward of
   torch's scaled_dot_product_attention;
12. training smollm-360m at full width and depth (32 layers, random
   weights from a seed) through run_training: 6 AdamW steps on
   TokenPipeline batches of 8 x 1,024 tokens, bf16 compute, f32 master
   weights and Adam state, remat: finite and falling loss, launch counts
   (B4 64, B5 32, B6 32, B7 and B8 0 per step), no parameter without a
   gradient, every B5/B6 call of a step within 2 bf16 ulps of its plain
   version as it comes and again with dO scaled by a power of two that
   brings the largest gradient into [0.5, 1) (a control with one call's
   dq at 4 mantissa bits must exceed that), float32 gradients of a 2 x
   512-token step within 1e-4 of the plain versions' (a control with
   layer 0's dQ at 6 mantissa bits must exceed that), and at 4 layers 4
   straight steps bitwise equal to 2 steps + checkpoint save + restore +
   2 steps; step time, tokens/s, peak memory and the device time of one
   step by kernel (B4, B5 and B6 each);
13. the sweep engine (repro_torch.sweeps.run_sweep, tracing on, each part
   into its own store): Fig. 3 at the §VI-B widths (synthetic, 2,000
   users, seeds 0-7; EGP and AGP on the card through evaluate_batch, SCK,
   RND and OPT on the host) with the accelerator values within 1e-4 of
   egp_np/agp_np and the host columns bit-identical to a run on the CPU,
   its table and the mean EGP/OPT ratio logged; the same generator at
   10,000 users (seeds 0-3, one-item chunks) within 1e-4 of the host, one
   item's launches (B1 once, B3 once a greedy iteration), its device time
   by kernel, each executor's items/s and the obs span totals; every
   registered scenario at its own configuration (seeds 0-3) within 1e-4
   of the host, with edge_failure's dead edges placing nothing from their
   failure tick on; flash_crowd and edge_failure killed after two one-item
   chunks and resumed (a third call computes nothing), bit-identical to a
   one-shot run, to a globally padded run and to a run with tracing off;
   and Fig. 3's accelerator values bit-identical with B1's and B3's plain
   versions;
14. the serving tick: phase 3's 10^6-user tick again through the
   candidate build and egp_place_sparse_torch(with_trace=True), counted
   (B2 once, B3 once an iteration, as many as phase 3's), with x and the
   iterations bit-identical to phase 3's, the traced and untraced loop
   times, the trace's bytes on the card, and its ledger record (ingested
   on the host) with as many picks as the trace and its gains within
   1e-3 relative of σ; every registered scenario's serving horizon
   (host NumPy) at the serving-horizon benchmark's load under EDF, FCFS
   and feedback, seeds 0-1: conservation, a rerun and a run with the
   obs tracer, the decision ledger and the request tracer on
   byte-identical, seed 0's result digests equal to the reference's
   (TICK_DIGESTS), realized QoS, miss rates and the tick span totals
   logged; and a kind="serving" sweep of flash_crowd and edge_failure,
   seeds 0-3, killed after one chunk, resumed and reloaded, bit-identical
   to a one-shot run;
15. serving the MoE family at its published widths, depth cut to fit one
   card (MOE_DEPTH: mixtral-8x7b at 4 of 32 layers, 8 experts top-2,
   d_ff 14,336, SWA 4096; qwen3-moe-235b-a22b at 2 of 94, 128 experts
   top-8, d_ff 1,536, 64/4 heads) as phase 7 serves smollm: launch counts,
   every B4/B7 call held, bf16 logits within limits that controls exceed,
   float32 logits within 1e-4, and layer 0's top-k experts and dropped
   assignments on the card equal to the CPU's on the same hidden state
   (but at near ties);
16. the frontends at full width and depth: hubert-xlarge's forward of 8 x
   1,024 audio frames (non-causal B4 at hd 80, G = 1) and internvl2-1b's
   prefill of 1,024 patch embeddings + 512 tokens and 32 decode steps,
   with the same per-call and logit gates;
17. the edge cluster: run_serving (the launcher's entry point) on the card
   at 48 users / 2 edges / 60 GiB and at 24 / 2 / 1,000 GiB, each with
   edge 0 failing: placement, routing, served/dropped/skipped and requests
   per model equal to the reference's (CLUSTER_EXPECTED), expected QoS
   within 1e-6, each resident smoke model's B4/B7/B8 launches per
   generate, B1 once per placement or routing, realized QoS and the wall
   time of each request batch; then every kernel call of the same runs
   held against its plain version;
18. the live control plane: phase 3's 10^6-user tick (evaluate_sparse +
   Router.route) and one 10^4-user sweep item of phase 13 under
   torch.profiler with obs annotations on (profile_trace), where every
   launch of B1, B2 and B3 must appear by name, as many times as LAUNCHES
   counts, each inside its dispatcher's named scope, with their device
   ms; every registered scenario x EDF/FCFS/feedback at seed 0 and the
   serving benchmark's load replayed through the virtual-clock gateway
   with the stream on to one file: each result digest equal to
   TICK_DIGESTS, the file accepted whole by FrameValidator with one
   gateway frame a tick, the default SLOs and one dashboard screen
   printed; a wall-clock soak over TCP on 127.0.0.1 (SOAK), which must
   run clean (no exception, no malformed frame, no request dropped at
   ingress; its verdict and its late requests, which judge the host's
   clock, printed, not gated); and pareto_mask_torch on
   the card equal to pareto_mask_np on seeded grids up to 4,096 x 3 in
   float32 and float64 and below float32 resolution, frontier_points over
   phase 14's serving store the same through the device and the NumPy
   mask, with the device mask's time (CUDA events) beside NumPy's;
19. the SSD scan's backward kernel (csrc/ssd_scan_bwd.cu) against the
   float64 plain backward (ssd_chunked_bwd) at the mamba2 and zamba2
   training shapes ([8, 1024, 80, 64], N 128 and 64, chunk 256), one chunk,
   a ragged length, a chunk of 40, and P = N = 16 with 2 and 5 chunks, with
   and without an initial state and dfinal: every gradient within 3e-4 of
   its largest |value|, two calls bit-equal, and a control with one head's
   x and dy zeroed whose db and dc read above 3e-4 (the sums over heads
   are taken on chip); its time (CUDA events and device time), the host's
   share of a call, the plain backward's, autograd of ssd_chunked's, its
   bound and the split plan's; then B8 and the backward on HEAD_BLOCKS
   head blocks of the mamba2 shape, as the tensor-parallel Mamba block's
   model ranks call them: y, the final state, dx and ddtA bit-equal to the
   same heads of the whole call, db/dc summed over the blocks in order
   within 3e-4 of the whole call's, a head-dropped control above it, each
   block's time beside the whole call's;
20. training mamba2-2.7b and zamba2-2.7b at full width and depth through
   run_training (6 steps of 8 x 1,024 tokens, bf16 compute, f32 master
   weights and Adam state, remat): launch counts per step exact (B8 twice
   and the SSD backward once a Mamba layer; zamba2's B4 twice and B5, B6
   once a shared-block application), no plain SSD function called, finite
   and falling losses, every parameter with a gradient, step time,
   tokens/s, peak memory and one step's device time by kernel; every SSD
   backward call of one bf16 step within 3e-4 of the plain backward on
   its inputs, and the first again with one head's x and dy zeroed, its
   db and dc above 3e-4; and at full width and cut depth one float32 step
   with kernels against the same step with the plain versions, the loss and
   every gradient leaf within 3e-4 of its largest |value| (the two
   kernels' shares read apart), beside a control with every layer's scan
   output and its gradient rounded to bf16;
21. training every remaining family at its published widths through
   make_train_step (6 steps, bf16 compute, f32 master weights and Adam
   state, remat; FAMILY_TRAINED): gemma2-27b at 2 of 46 layers (swa and
   full, its attention softcap through B4-B6), mixtral-8x7b at 2 of 32,
   qwen3-moe-235b-a22b at 1 of 94, hubert-xlarge at 24 of 48 and
   internvl2-1b at 12 of 24 (internvl2 over 1,024 patches + 512 tokens a
   row): launch counts
   per step exact (B4 twice, B5 and B6 once an attention layer), no plain
   attention called, finite losses, the loss on the first batch lower
   after the last step, every parameter with a gradient, the first
   step's peak memory under FAMILY_PEAK_GB, step time, tokens/s, peak
   memory and one step's device time by kernel; at cut depth one float32
   step with kernels against the plain versions, the loss and every leaf
   within FAMILY_GRAD_TOL of its scale, beside a control with layer 0's
   dQ at 6 mantissa bits; for the MoE models, layer 0's moe_local backward
   at full width bit-equal twice in bf16 and within GRAD_TOL of float64;
   for gemma2, remat_policy="save_attn" beside "nothing" (the same
   gradients bit for bit, B4 once an attention layer a step instead of
   twice, step ms and peak memory of each); then run_training(preset=
   "tiny") on the card for every smoke config whose head width is 16
   (command-r, yi, mixtral, qwen3-moe, hubert, zamba2) with the same
   launch, loss and gradient checks.

22. the fleet on the card: a sigma-kind sweep at phase 13's 10^4-user width
   (EGP and AGP, FLEET_SEEDS seeds, one item a task) run by one process,
   then planned by repro_torch.fleet and drained by FLEET_WORKERS `python
   -m repro_torch.fleet worker --device cuda` processes (each a CUDA
   context of its own) with REPRO_OBS on, the holder of the first lease
   SIGKILLed: every other worker exits 0, the lease is reaped and mopped
   up in process, the merge holds every value bit-equal to the single
   process's and run_sweep on the merged store computes nothing; the
   surviving workers' B1/B3 launches read from their stitched obs
   artifacts; wall times, items/s and each worker's telemetry rate; then
   `python -m repro_torch.sweeps --fleet 2 --device cuda --validate` on
   two scenarios x two seeds (its final run_sweep computes 0 chunks,
   within 1e-4 of the host path; a second call plans 0 tasks);
23. the int8 implementation variants at full width and depth
   (repro_torch.models.quant): smollm-360m and mamba2-2.7b quantized on
   the card, quantized_bytes equal to QUANT_BYTES (the reference's count)
   and its ratio to bf16 beside the catalog's 0.52, smollm's int8 values
   and scales bit-equal to the CPU's; the bf16-dequantized model's top-1
   agreement over 8 x 1,024 probe tokens through B4 (smollm) or B8
   (mamba2), launches counted, beside a model against itself (1.0) and
   against another seed's (near chance);
24. compressed training: run_training(compression="topk" and "int8") of
   smollm-360m at phase 12's shape: finite losses, phase 12's B4/B5/B6
   launches, the median step beside phase 12's, the carry's bytes and the
   peak memory; the next step's gradients through ErrorFeedback on the
   card equal to the same transform on the CPU (topk bit for bit, int8 on
   the card's draws), the carry equal to corrected - kept;
25. the device mesh on the card: torch.cuda.device_count() NCCL ranks
   (spawned processes, one a card; one on a one-card machine), each on
   make_host_mesh(model=1), under a deadline of MESH_TIMEOUT_S. For
   smollm-360m at full width and depth (its float32 gradient at 8 layers),
   mixtral-8x7b at full width and 2 of its 32 layers and mamba2-2.7b at 2
   of its 64 (its heads split over the model axis): one float32 GRAD_B x
   GRAD_S gradient without a mesh (one microbatch a data rank: the mesh's
   MoE gives each data rank's tokens their own capacity) and on the mesh,
   each rank fed its shard_batch block of the batch, with sp_matmuls off
   and on (on where the heads and d_ff split), the loss and every
   leaf within GRAD_TOL of its largest |value|, B4/B5/B6 launches equal
   to the no-mesh step's, the collectives' counters non-zero; then
   MESH_STEPS bf16 steps of TRAIN_B x TRAIN_S tokens without and with the
   mesh (smollm through run_training(mesh=...), mixtral through
   make_train_step with sp_matmuls on), the losses within the step
   tolerances of each other, the step ms side by side; smollm (8 layers)
   and mamba2 again with the training state stored as each rank's blocks
   (shard_train_state) beside the replicated state: equal losses and
   launches, every block bit-equal after MESH_STEPS steps, each rank's
   state bytes and peak memory; mamba2's sharded state saved with
   mesh=/pspecs= and restored bit-equal into another sharded state;
   compressed_psum on the card bit-equal to its CPU result on the card's
   draws; the world size and the mesh shapes;
26. serving on the device mesh: B7's block variant (a block of a cache's
   slots with the whole cache's valid range, and its logsumexp) at
   smollm's serving decode (an empty block), mixtral's batch-1 ring
   wrapped past 8,192 positions, zamba2's batch-1 8,224 slots and a
   window, each block held per call against its plain version (B7's gate,
   the lse within SERVE_LSE_TOL), the blocks combined against the whole
   cache's launch, one block timed beside its bound and SDPA; then
   torch.cuda.device_count() NCCL ranks, each on make_host_mesh(model=1),
   serving smollm-360m, mamba2-2.7b and zamba2-2.7b at full width and
   depth and mixtral-8x7b at 4 of 32 layers (SERVE_B x SERVE_PROMPT
   prompts, SERVE_STEPS greedy steps through prefill(ctx=) and
   decode_step(ctx=) on each rank's shard_batch blocks of the prompt and
   of each step's tokens, each rank's vocabulary block of the logits
   gathered whole for the argmax, the caches as each rank's blocks)
   beside the same without the mesh: in float32 the greedy tokens equal
   and the prefill logits within SERVE_MESH_TOL, in both dtypes each
   rank's launches equal; prefill ms, decode ms a step, a decode step's
   collectives, the peak memory, and a rank's prompt and logits bytes
   beside the whole ones;
27. the dry run against the card: phase 12's step traced on fake CUDA
   tensors (its kernel calls against _per_step, its predicted peak
   within DRY_RUN_PEAK_TOL of max_memory_allocated over one real step),
   smollm-360m's training cell on rank 0 of a fake (2, 2) process group
   (its traced argument bytes equal to the bytes of the same blocks made
   real, the inputs shard_batch's blocks), and the dry-run CLI on
   DRY_RUN_CELL in a child process.

It prints a JSON line of per-kernel numbers and, last, the device line
``{"ok": true, "device": {...}}``. It needs the repository around it and
exits nonzero where torch sees no CUDA device.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Main-path scale (the §VI-B catalog: 100 services, ≤ 10 implementations).
U_MAIN, E_MAIN, SEED = 1_000_000, 1000, 0
#: Serving path: batch, prompt length, new tokens, cache slots.
SERVE_B, SERVE_PROMPT, SERVE_STEPS, SERVE_SEQ = 8, 1024, 32, 2048
#: H100 SXM peaks (data sheet): HBM bytes/s, non-tensor-core f32 op/s and
#: bf16 tensor-core op/s.
HBM_BYTES_S, F32_OPS_S, BF16_OPS_S = 3.35e12, 67e12, 989e12
REPS = 25
QOS_TOL = 1e-6
#: The batched path: the reference benchmark's mixed-size batch at U0 =
#: 10,000 users (benchmarks/placement_scale.py, under its dense_max_u of
#: 20,000), values within the reference's batched-vs-host tolerance
#: (tests/test_workloads.py).
BATCH_U0, BATCH_ATOL = 10_000, 1e-4
#: A paper-scale case whose host opt_np takes longer is left out of the
#: OPT check (and says so).
OPT_HOST_LIMIT_S = 60.0
#: max abs error of an attention kernel against its plain version, by
#: dtype (the JAX package's own kernel tolerances, tests/test_kernels.py).
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: bf16 outputs of a kernel and its plain version, which compute the same
#: float32 values in different orders, round to the same or neighbouring
#: bf16 values: |kernel - plain| <= 2 bf16 ulps of |plain| + 1e-5 (the
#: float32 readings stay below 1.2e-6).
BF16_ULPS, BF16_ATOL = 2, 1e-5
#: max abs difference of float32 logits, the port's model tolerance against
#: the JAX package (tests/test_torch_models.py).
F32_LOGITS_TOL = 1e-4
#: Attention shapes of the MoE family's serving path (label, B, S, Hq,
#: Hkv, hd): mixtral-8x7b's 32/8 heads (G = 4) and qwen3-moe-235b's 64/4
#: (G = 16), hd 128, at the serving batch and prompt; and the smoke configs'
#: hd = 16 at the edge cluster's bucket (4 rows, 16-token prompts): mixtral
#: and qwen3-moe 4/2, yi 8/2, command-r 8/1, zamba2's shared block 4/4.
MOE_ATTN_SHAPES = [("mixtral width", SERVE_B, SERVE_PROMPT, 32, 8, 128),
                   ("qwen3-moe width", SERVE_B, SERVE_PROMPT, 64, 4, 128)]
SMOKE_ATTN_SHAPES = [("smoke hd=16 G=2", 4, 16, 4, 2, 16),
                     ("smoke hd=16 G=4", 4, 16, 8, 2, 16),
                     ("smoke hd=16 G=1", 4, 16, 4, 4, 16)]
#: Controls of a served model's bf16 logits limit (SERVED): the plain model
#: with layer 0's attention or SSD output rounded to b mantissa bits (bf16
#: keeps 7), for each b of CONTROL_SWEEP; the one at CONTROL_BITS must land
#: above the limit, so the limit tells a layer degraded that far from
#: rounding drift.
CONTROL_BITS, CONTROL_SWEEP = 2, (6, 5, 4, 3, 2)
#: max abs error of the SSD scan kernel against a plain version, after
#: dividing both by the plain version's largest |value| (the reference's
#: 3e-4 kernel tolerance, tests/test_kernels.py).
SSD_TOL = 3e-4
#: Each served model: the model-layer functions whose layer-0 output the
#: control rounds; the bf16 teacher-forced logits limit (kernels vs plain,
#: max abs), which the control at CONTROL_BITS must exceed; and a limit on
#: the root-mean-square difference with the number of mantissa bits of
#: the control that must exceed it. Set from H100 readings (kernels vs
#: plain; control): max abs smollm 0.0527 (about 6 bf16 ulps at its
#: largest logit, 3.25) and 0.1426 at b = 2, mamba2 0.2004 and 0.2998,
#: zamba2 0.1719 and 0.2891; rms smollm 0.00916 and 0.0164 at b = 3,
#: mamba2 0.0336 and 0.0513 at b = 6, zamba2 0.0333 and 0.0471 at b = 6.
#: In the Mamba stacks the max abs limit tells only a gross fault from
#: rounding (a control at b = 6 already reads 0.27-0.28 there); the rms
#: limit resolves one layer at 6 mantissa bits, and the per-call checks
#: are the fine gate. The MoE models' and hubert's controls round every
#: layer's attention output (control_every=1). H100 readings (kernels vs
#: plain; control): mixtral (4 layers) max abs 2.527 and 8.969 at b = 2,
#: rms 0.0619 and 0.184 at b = 6; qwen3-moe (2 layers) 1.586 and 2.869,
#: rms 0.0604 and 0.103; hubert 0.148 and 0.184, rms 0.0244 and 0.0329 at
#: b = 2; internvl2 0.108 and 0.536, rms 0.0160 and 0.0448 at b = 3. An
#: MoE model's bf16 drift is large because a bf16 ulp in the hidden state
#: can flip a token's top-k experts; in hubert's 48 non-causal layers
#: rounding noise is as large as a control, so there the per-call and
#: float32 checks are the gates and the logit limits catch gross faults
#: only.
SERVED = {
    "smollm_360m": dict(control=("attention", "decode_attention"),
                        bf16_tol=0.1, bf16_rms=(0.013, 3)),
    "mamba2_2p7b": dict(control=("ssd", "ssd_decode_step"), bf16_tol=0.25,
                        bf16_rms=(0.042, 6)),
    "zamba2_2p7b": dict(control=("ssd", "ssd_decode_step"), bf16_tol=0.25,
                        bf16_rms=(0.042, 6)),
    "mixtral_8x7b": dict(control=("attention", "decode_attention"),
                         control_every=1, bf16_tol=4.0, bf16_rms=(0.12, 6)),
    "qwen3_moe_235b": dict(control=("attention", "decode_attention"),
                           control_every=1, bf16_tol=2.2,
                           bf16_rms=(0.08, 6)),
    "hubert_xlarge": dict(control=("attention",), control_every=1,
                          bf16_tol=0.165, bf16_rms=(0.03, 2)),
    "internvl2_1b": dict(control=("attention", "decode_attention"),
                         bf16_tol=0.2, bf16_rms=(0.03, 3)),
}
#: Phase 15 serves the MoE family at the serving load with its depth cut
#: to fit one card in bfloat16 with float32 master weights (mixtral-8x7b's
#: 32 layers hold 93 GB in bf16 alone; 4 hold about 24 GB in float32;
#: qwen3-moe-235b's 2 of 94 about 25 GB). Layer 0's routing on the card
#: may differ from the CPU's only where two of a token's top k + 1 router
#: probabilities lie within MOE_TIE_GAP.
MOE_DEPTH = {"mixtral_8x7b": 4, "qwen3_moe_235b": 2}
MOE_TIE_GAP = 1e-6
#: Phase 16: internvl2-1b's prompt, patch embeddings then tokens.
FRONTEND_PATCHES, FRONTEND_TOKENS = 1024, 512
#: The model-layer dispatchers that launch a kernel on the serving path.
KERNEL_DISPATCHERS = ("attention", "decode_attention", "ssd")
#: Training path: steps of the full-size run, batch, sequence length and
#: peak learning rate (3e-4: GPT-3's for its 350M model, Brown et al. 2020,
#: Table 2.1; run_training's default 1e-3 made the full model's loss spike
#: within 6 steps on an H100); the float32 gradient check's batch and
#: length; the resume check's depth.
TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_LR = 6, 8, 1024, 3e-4
GRAD_B, GRAD_S, RESUME_LAYERS = 2, 512, 4
#: float32 gradients, kernels vs plain, each leaf's max abs difference over
#: its largest |value| (the port's float32 gradient tolerance against the
#: JAX package, tests/test_torch_training.py); the control rounds layer
#: 0's dQ to GRAD_CONTROL_BITS mantissa bits and must exceed it.
GRAD_TOL, GRAD_CONTROL_BITS = 1e-4, 6
#: The control of phase 12's per-call B5/B6 reading at scaled dO rounds one
#: call's dq to this many mantissa bits. bf16 keeps 7, so rounding to 6
#: moves a value by at most one bf16 ulp (a tie rounds away), which a
#: 2-ulp gate passes by design; at 4 bits a tie moves it by 4 ulps.
CALL_CONTROL_BITS = 4
#: B5/B6 in float32 against the plain version: max abs difference over the
#: plain output's largest |value|, or over 1 where that is smaller (the
#: reference's absolute 3e-4, tests/test_kernels.py).
BWD_TOL = 3e-4
#: Phase 11's cases at the training families' shapes (label, B, Sq, Skv,
#: Hq, Hkv, hd, causal, window, softcap): gemma2-27b's heads (32/16, hd
#: 128) with its attention softcap and a window below Sq; hd = 16 at the
#: smoke shapes phase 6 gives B4 (SMOKE_ATTN_SHAPES, 4 rows of 16 tokens:
#: G = 2, 4 and 1); qwen3-moe-235b's G = 16 at hd 128; internvl2-1b's
#: 14/2 heads (G = 7) at hd 64.
BWD_FAMILY_CASES = (
    [("gemma2 softcap 50, window 512", 2, TRAIN_S, TRAIN_S, 32, 16, 128,
      True, 512, 50.0)]
    + [(label, B, S, S, Hq, Hkv, hd, True, 0, 0.0)
       for label, B, S, Hq, Hkv, hd in SMOKE_ATTN_SHAPES]
    + [("qwen3-moe G = 16, hd = 128", 2, TRAIN_S, TRAIN_S, 64, 4, 128, True,
        0, 0.0),
       ("internvl2 G = 7, hd = 64", 2, TRAIN_S, TRAIN_S, 14, 2, 64, True, 0,
        0.0)])
#: Phase 19, the SSD scan's backward kernel: each gradient within
#: SSD_TOL of its largest |value| against the float64 plain backward
#: (ssd_chunked_bwd), B8's forward gate mirrored. Phase 20 trains these
#: models at full width and depth (TRAIN_STEPS steps of TRAIN_B x TRAIN_S
#: tokens), holds every SSD backward call of one bf16 step within SSD_TOL
#: of the plain backward on its own inputs, and holds one float32 step
#: with kernels against the same step with use_kernel=False at full width
#: and the depth in SSM_GRAD_DEPTH (mamba2 2 layers, zamba2 one segment of
#: 6 Mamba layers and a shared block), each gradient leaf within
#: SSM_GRAD_TOL of its largest |value|. The worst leaves are A_log and
#: dt_bias, sums over every position of terms that mostly cancel: there
#: the kernels read up to 9.0e-5 (H100, PR 25), and so does the backward
#: kernel alone or B8 alone against the plain versions (float32 sums in
#: another order), while every other leaf reads far less. The control
#: rounds every layer's scan output and the gradient reaching it to
#: SSM_CONTROL_BITS mantissa bits (bf16's 7) and must exceed the limit:
#: it read 1.3e-3 to 2.2e-3.
#: Phase 19 also runs B8 and the backward on head blocks of the mamba2
#: training shape: HEAD_BLOCKS blocks of its 80 heads, a model rank's share
#: of the tensor-parallel Mamba block at model = HEAD_BLOCKS.
HEAD_BLOCKS = 4
SSM_TRAINED = ("mamba2_2p7b", "zamba2_2p7b")
SSM_GRAD_DEPTH = {"mamba2_2p7b": 2, "zamba2_2p7b": 6}
SSM_GRAD_TOL, SSM_CONTROL_BITS = 3e-4, 7
#: Phase 21 trains every remaining family at its published widths:
#: TRAIN_STEPS steps through make_train_step, bf16 compute, f32 master
#: weights and Adam state, remat, at (layers, batch rows, positions):
#: gemma2-27b at 2 of its 46 layers (one swa, one full), mixtral-8x7b at
#: 2 of 32 and qwen3-moe-235b-a22b at 1 of 94 (the state of 16 bytes a
#: parameter, 37.0, 50.6 and 59.7 GB, has to fit the card's 80 GB beside
#: the step), hubert-xlarge at 24 of 48 and internvl2-1b at 12 of 24 (cut
#: to keep the script's time as phases 19 and 25 grew);
#: internvl2 at 1,024 patches + 512 tokens a row (phase 16's prompt: at
#: TRAIN_S its 1,024 patches would leave no text token, and its token
#: table no gradient). A first step above FAMILY_PEAK_GB fails the phase
#: (the batch is then to be halved and the cut recorded; on an H100 the
#: largest, qwen3-moe's, read 63.01 GB at 8 rows). The float32 check runs
#: one step at FAMILY_GRAD_DEPTH layers (internvl2 at FAMILY_GRAD_SEQ
#: positions), kernels against use_kernel=False, the loss and every leaf
#: within GRAD_TOL of its largest |value| (H100: 2.2e-6 to 8.7e-6, the
#: softcap's leaves included), and a control with layer 0's dQ at
#: GRAD_CONTROL_BITS mantissa bits that must exceed it (2.8e-3 to
#: 3.6e-3). SAVE_ATTN_TRAINED also compares
#: remat_policy="save_attn" with "nothing" (SAVE_ATTN_STEPS steps in
#: turns). TINY_TRAINED: the smoke configs whose head width is 16, each
#: through run_training(preset="tiny") on the card for TINY_STEPS steps.
FAMILY_TRAINED = {"gemma2_27b": (2, TRAIN_B, TRAIN_S),
                  "mixtral_8x7b": (2, TRAIN_B, TRAIN_S),
                  "qwen3_moe_235b": (1, TRAIN_B, TRAIN_S),
                  "hubert_xlarge": (24, TRAIN_B, TRAIN_S),
                  "internvl2_1b": (12, TRAIN_B, FRONTEND_PATCHES
                                   + FRONTEND_TOKENS)}
FAMILY_PEAK_GB = 76.0
FAMILY_GRAD_DEPTH = {"gemma2_27b": 2, "mixtral_8x7b": 2,
                     "qwen3_moe_235b": 1, "hubert_xlarge": 4,
                     "internvl2_1b": 4}
FAMILY_GRAD_SEQ = {"internvl2_1b": FRONTEND_PATCHES + GRAD_S}
SAVE_ATTN_TRAINED, SAVE_ATTN_STEPS = ("gemma2_27b",), 4
#: Tokens of the MoE backward reading (bit-equal bf16 calls, float32 vs
#: float64) of each MoE run.
MOE_BWD_TOKENS = 2 * TRAIN_S
TINY_TRAINED = ("command_r_35b", "yi_34b", "mixtral_8x7b",
                "qwen3_moe_235b", "hubert_xlarge", "zamba2_2p7b")
TINY_STEPS = 10
#: Phase 13, the sweep engine: Fig. 3 at the §VI-B widths (the reference
#: sweep spec's _SYNTH_DEFAULTS: 10 edges, 100 services, U{1..10}
#: implementations) with 2,000 users and 8 seeds; the same generator at
#: 10,000 users (600 MB an item by bytes_per_item, so one-item chunks at
#: the default 512 MB budget) for 4 seeds; every registered scenario at its
#: own configuration for 4 seeds. Accelerator values are held within the
#: reference's host-parity tolerance of the host path
#: (repro/sweeps/shard.py HOST_PARITY_ATOL).
SWEEP_FIG3_USERS, SWEEP_FIG3_SEEDS = 2000, 8
SWEEP_FULL_USERS, SWEEP_FULL_SEEDS = 10_000, 4
SWEEP_SCENARIO_SEEDS, SWEEP_ATOL = 4, 1e-4
SWEEP_SCENARIOS = ("diurnal", "edge_failure", "flash_crowd",
                   "mobility_churn", "steady", "trace_replay",
                   "trace_replay_azure", "trace_replay_bursty")
#: Phase 14, the serving tick: the serving-horizon benchmark's load point
#: (benchmarks/serving_horizon.py LOAD: long prompts and small batches, so
#: the executors congest), every registered scenario at its own n_ticks
#: under the three policies, seeds 0-1; then a kind="serving" sweep of
#: flash_crowd and edge_failure, seeds 0-3, killed and resumed.
TICK_LOAD = dict(prompt_tokens=768, new_tokens=64, max_batch=4)
TICK_POLICIES = ("edf", "fcfs", "feedback")
TICK_SEEDS = (0, 1)
TICK_SWEEP_SCENARIOS, TICK_SWEEP_SEEDS = ("flash_crowd", "edge_failure"), 4
#: The traced sparse tick's ledger gains telescope to σ only to float32
#: summation order (the reference's documented ~1e-3 relative,
#: tests/test_obs_v3.py::test_sparse_trace_parity_and_gain_sum).
TRACE_GAIN_RTOL = 1e-3
#: result_digest of seed 0's horizon at TICK_LOAD per (scenario, policy),
#: as the reference computes it (tests/test_torch_tick.py recomputes every
#: one from the reference, so they cannot go stale).
TICK_DIGESTS = {
    ("diurnal", "edf"):
        "1ba04c1ea1fb59f19220acf13dfdde0b1817a402be91dd3a07911342d8da3848",
    ("diurnal", "fcfs"):
        "b94da5325545c3c993b2908510552f36c43207d470af2759d2b1c9303ccbc630",
    ("diurnal", "feedback"):
        "49b1feb3d0f32d078b35c854f3503efa264d53539151832875bf17ed1b3c6008",
    ("edge_failure", "edf"):
        "b152f6bed039db0ee148d402db82a47d3ac4e647ee15bc0f9d2f565c6dc1f5aa",
    ("edge_failure", "fcfs"):
        "a63ff569f15352f4cd2532fa82fc48aa25969f360a245bbf92c0dfefa39ebfc3",
    ("edge_failure", "feedback"):
        "7eaf9ba493ab19667509bda66b8dd4edc80ede80b856b7dd9094e0168afc2e17",
    ("flash_crowd", "edf"):
        "9b0d6946e6c663e65a1cdba6b7efd165c7a929c6a0a7f8470dcbae209b1fac71",
    ("flash_crowd", "fcfs"):
        "345a33944c4f78b183e7ff681d17da4359a8da770b589d0feb179c1751fd6ecd",
    ("flash_crowd", "feedback"):
        "bf4b32c8cd7609c7a893f87c1bbb0e163b0be61caae5f554d19bdde081e0af43",
    ("mobility_churn", "edf"):
        "06ea50b638a22d6c5cfd549d435bf9b79af6184c116970cc1bb11754887e1a68",
    ("mobility_churn", "fcfs"):
        "3819c685f357012c63faabaf2a6533279bc46f7dcf3786a0d866f6780de6d3a5",
    ("mobility_churn", "feedback"):
        "e6bd56292460f93cf2f43bec94ae2f81029554931b19f045aff6260f6b8232fe",
    ("steady", "edf"):
        "97b490486d3d154bdc6872badd788f244713e19d5f0b5450e15959e7135e3c81",
    ("steady", "fcfs"):
        "0e0544ffbf3b4d9d5f14d7116e957bf7bbcda3ff8cbb75c1326b5dc9b6508008",
    ("steady", "feedback"):
        "98c9c62cae1ef94ad654fe1c19732427b863e6a38683bdf32c73e6c99b186379",
    ("trace_replay", "edf"):
        "2352ac638ca24a45e22906b361b05467fcef1cc5e6bfb8618f8b99ab0f0b8649",
    ("trace_replay", "fcfs"):
        "03ac9c9a174343f4e852b3a33ab1a5f3046c6a94d74463269944dd3f2d259b40",
    ("trace_replay", "feedback"):
        "e2adfea223b8632fcc8834686ba0d394251b3e241d403674f95f7236ec3925da",
    ("trace_replay_azure", "edf"):
        "f5b2280b8374f0da1eebaacf06ece95aa6ce20fe1104a15a85e686669dcb8b6e",
    ("trace_replay_azure", "fcfs"):
        "ed5f847a7838da0f43cd16f17f4031aada5a09112feaac37a545f73c652766dd",
    ("trace_replay_azure", "feedback"):
        "4b3c765fae697dce91877611d349aaa94b3c42e99d0bc61a034f8a7e1191c5ef",
    ("trace_replay_bursty", "edf"):
        "4b9f14aab3d0ca5822e0bc0f64263dac8559f99b728015bf1fc9a58c3c77e2ec",
    ("trace_replay_bursty", "fcfs"):
        "5f488703f0cec486d4ff7688f8c1381ce8cf0235471552d3f9bb7e93e1704e90",
    ("trace_replay_bursty", "feedback"):
        "584dbdf8ca2359cd0dc371c539d254e60b9332f1507b0a4db3775e01ae6d2c59",
}
#: Phase 17, the edge cluster: run_serving at (users, edges, storage GiB)
#: with edge CLUSTER_FAIL_EDGE failing after the first serve. Storage 60
#: (the launcher's default) places no MoE or 34-35B model; 1000 places all
#: ten catalog models. Each case's decisions before and after the failure
#: as the reference computes them on the CPU (tests/test_torch_cluster.py
#: recomputes every one from the reference, so they cannot go stale):
#: the implementations placed on each edge (catalog indices: 0 smollm, 1
#: zamba2, 2 mamba2, 3 mixtral, 4 yi, 5 gemma2, 6 command-r, 7 qwen3-moe, 8
#: hubert, 9 internvl2), each user's routed implementation, the served,
#: dropped and skipped counts, requests per model and the mean expected
#: QoS (held within QOS_TOL).
CLUSTER_CASES = ((48, 2, 60.0), (24, 2, 1000.0))
CLUSTER_FAIL_EDGE = 0
CLUSTER_EXPECTED = {
    (48, 2, 60.0): (
        dict(placed=((0, 1, 5, 8, 9), (0, 1, 2, 8, 9)),
             assignment=(8, 9, 9, 8, 9, 9, 9, 8, 9, 1, 8, 9, 9, 8, 8, 1, 8,
                         8, 9, 9, 1, 9, 8, 8, 9, 8, 5, 1, 9, 8, 8, 8, 9, 8,
                         5, 9, 1, 1, 9, 8, 5, 1, 8, 9, 8, 9, 1, 1),
             served=48, dropped=0, skipped=0,
             counts={"gemma2_27b": 3, "hubert_xlarge": 18,
                     "internvl2_1b": 18, "zamba2_2p7b": 9},
             expected_qos=0.9164674098681376),
        dict(placed=((), (0, 1, 2, 8, 9)),
             assignment=(8, 9, 9, 8, 9, 9, 9, 8, 9, 1, 8, 9, 9, 8, 8, 1, 8,
                         8, 9, 9, 1, 9, 8, 8, 9, 8, 1, 1, 9, 8, 8, 8, 9, 8,
                         1, 9, 1, 1, 9, 8, 1, 1, 8, 9, 8, 9, 1, 1),
             served=48, dropped=0, skipped=0,
             counts={"hubert_xlarge": 18, "internvl2_1b": 18,
                     "zamba2_2p7b": 12},
             expected_qos=0.9065084290665303)),
    (24, 2, 1000.0): (
        dict(placed=((0, 1, 2, 3, 4, 5, 6, 7, 8, 9),
                     (0, 1, 2, 3, 4, 5, 6, 7, 8, 9)),
             assignment=(7, 9, 3, 8, 7, 7, 8, 8, 8, 7, 1, 7, 7, 9, 8, 8, 7,
                         8, 9, 8, 8, 9, 9, 9),
             served=24, dropped=0, skipped=0,
             counts={"hubert_xlarge": 9, "internvl2_1b": 6,
                     "mixtral_8x7b": 1, "qwen3_moe_235b": 7,
                     "zamba2_2p7b": 1},
             expected_qos=0.9427205702375941),
        dict(placed=((), (0, 1, 2, 3, 4, 5, 6, 7, 8, 9)),
             assignment=(7, 9, 1, 8, 7, 3, 8, 8, 8, 3, 1, 7, 1, 9, 8, 8, 7,
                         8, 9, 8, 8, 9, 9, 9),
             served=24, dropped=0, skipped=0,
             counts={"hubert_xlarge": 9, "internvl2_1b": 6,
                     "mixtral_8x7b": 2, "qwen3_moe_235b": 4,
                     "zamba2_2p7b": 3},
             expected_qos=0.9245804250109003)),
}
#: Phase 18, the control plane: the QoS kernels the profile must find by
#: name (LAUNCHES key, device kernel name, the named scope of their
#: dispatcher's CUDA branch); the wall-clock soak (TCP on 127.0.0.1,
#: flash_crowd at its own size and the serving benchmark's load, 10x the
#: trace's rate, one tick every 100 ms for 6 s); the Pareto grids (the
#: reference's test shapes and 4,096 x 3, seeds 0-1, float32 and float64,
#: quantized for ties).
PROFILED = (("qos_matrix", "qos_matrix_kernel", "qos_matrix_cuda"),
            ("qos_candidates", "topk_candidates_kernel",
             "qos_candidates_cuda"),
            ("greedy_argmax", "greedy_argmax_kernel", "greedy_argmax_cuda"))
SOAK = dict(scenario="flash_crowd", policy="feedback", speed=10.0,
            duration_s=6.0)
PARETO_SHAPES = ((1, 2), (17, 2), (64, 3), (128, 4), (1024, 3), (4096, 3))
PARETO_SEEDS = (0, 1)
#: Phase 22, the fleet on the card: the sigma kind at phase 13's 10^4-user
#: synthetic width, EGP and AGP, FLEET_SEEDS seeds (one task an item),
#: drained by FLEET_WORKERS `python -m repro_torch.fleet worker` processes
#: with leases of FLEET_TTL_S seconds, the holder of the first lease
#: SIGKILLed; then the sweep CLI's --fleet 2 --validate on two scenarios x
#: two seeds.
FLEET_WORKERS, FLEET_SEEDS, FLEET_TTL_S = 4, 8, 10.0
FLEET_CLI_SCENARIOS, FLEET_CLI_SEEDS = "steady,flash_crowd", "0:2"
#: Phase 23, the int8 variants at full width: quantized_bytes of each
#: model (tests/test_torch_quant.py recomputes both from the reference
#: through jax.eval_shape), and logit_agreement's probes.
QUANT_BYTES = {"smollm_360m": 409_211_520, "mamba2_2p7b": 2_702_790_304}
QUANT_PROBES, QUANT_SEQ = 8, 1024
#: Phase 24, compressed training of smollm-360m at phase 12's shape.
COMPRESSIONS = ("topk", "int8")
#: Phase 25, the mesh on the card: the models (arch, layers or None for
#: all), the bf16 steps of each without and with the mesh, their losses'
#: tolerances (the first step's, then every step's: tests/
#: test_integration.py), and the deadline of the spawned ranks.
MESH_MODELS = (("smollm_360m", None), ("mixtral_8x7b", 2),
               ("mamba2_2p7b", 2))
MESH_STEPS, MESH_FIRST_TOL, MESH_STEP_TOL = 3, 1e-4, 2e-3
#: The models trained again with their state stored as each rank's blocks
#: (shard_train_state), beside the replicated state on the same mesh: the
#: losses equal and each block after MESH_STEPS steps bit-equal to the
#: replicated state's; MESH_CKPT's sharded state is written and restored
#: with mesh=/pspecs=, bit-equal.
MESH_SHARDED = (("smollm_360m", 8), ("mamba2_2p7b", 2))
MESH_CKPT = "mamba2_2p7b"
#: Layers of the float32 mesh gradients where fewer than MESH_MODELS's.
MESH_GRAD_DEPTH = {"smollm_360m": 8}
MESH_TIMEOUT_S = 240
#: Phase 26, serving on the mesh: the models (arch, layers or None for
#: all; phases 7, 9, 10 and 15's serving cells), served SERVE_B x
#: SERVE_PROMPT and SERVE_STEPS greedy steps without and with the mesh;
#: the float32 prefill logits' gate (max |difference| over the largest
#: |logit|); B7's block variant checked on the card with its cache split
#: into SERVE_MESH_BLOCKS blocks of slots, its lse within SERVE_LSE_TOL of
#: the plain version's; and the batch-1 cases (arch, layers, prompt, cache
#: slots) with the KV slots over the batch axes that tools/mesh_phase.py
#: --serve runs on several cards: mixtral's 4,096-slot ring wrapped by an
#: 8,192-token prompt, zamba2's 8,224 slots.
SERVE_MESH = (("smollm_360m", None), ("mamba2_2p7b", None),
              ("zamba2_2p7b", None), ("mixtral_8x7b", 4))
SERVE_MESH_TOL, SERVE_LSE_TOL, SERVE_MESH_BLOCKS = 1e-4, 1e-5, 4
SERVE_SEQ_CASES = (("mixtral_8x7b", 4, 8192, 8224),
                   ("zamba2_2p7b", None, 8192, 8224))
SOURCE = {
    "qos_matrix": "src/repro_torch/csrc/qos_kernels.cu",
    "qos_candidates": "src/repro_torch/csrc/qos_kernels.cu",
    "greedy_argmax": "src/repro_torch/csrc/qos_kernels.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "gqa_decode": "src/repro_torch/csrc/gqa_decode.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
    "flash_attention_dq": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_dkv": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "ssd_scan_bwd": "src/repro_torch/csrc/ssd_scan_bwd.cu",
}
REPLACES = {
    "qos_matrix": "src/repro/kernels/qos_matrix/qos_matrix.py:120",
    "qos_candidates": "src/repro/kernels/qos_matrix/qos_matrix.py:190",
    "greedy_argmax": "src/repro/kernels/qos_matrix/qos_matrix.py:244",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:119",
    "gqa_decode": "src/repro/kernels/gqa_decode/gqa_decode.py:100",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:86",
    "flash_attention_dq":
        "src/repro/kernels/flash_attention/backward.py:145",
    "flash_attention_dkv":
        "src/repro/kernels/flash_attention/backward.py:164",
    # no Pallas counterpart: the reference differentiates its jnp
    # ssd_chunked (jax.grad under jax.checkpoint)
    "ssd_scan_bwd": "src/repro/models/layers.py:705",
}


#: Keys a kernel's row of the JSON line carries where its phase gives them:
#: B3's device times, B8's bound of the work its plan runs, notes, B1's
#: and B3's launches on phase 13's sweep, B2's and B3's on phase 14's
#: traced tick, and B1-B3's launches and device ms in phase 18's profile.
EXTRA_KEYS = ("device_ms", "library_device_ms", "plan_bound_ms",
              "plan_bound_by", "note", "sweep_launches", "trace_launches",
              "shapes", "moe_launches", "frontend_launches",
              "cluster_launches", "profile_launches", "profile_device_ms",
              "profile_ms_per_launch", "autograd_ms", "training_launches",
              "host_enqueue_ms", "head_block", "block")


def cluster_record(report, assignment) -> dict:
    """The decisions of one ``EdgeCluster.serve`` (either package's
    ``ServeReport``) and its router's assignment, in CLUSTER_EXPECTED's
    form."""
    return dict(placed=tuple(tuple(int(p) for p in row.nonzero()[0])
                             for row in report.placement),
                assignment=tuple(int(a) for a in assignment),
                served=int(report.served), dropped=int(report.dropped),
                skipped=int(report.skipped),
                counts=dict(sorted(report.per_model_counts.items())),
                expected_qos=float(report.mean_expected_qos))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls, each between two
    CUDA events on the current stream, after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ops(events) -> list:
    """The device's operations among a profile's events (``prof.events()``
    or ``key_averages()``): the program's ranges, which the profile also
    shows on the device's timeline as user annotations, are no device
    work."""
    import torch

    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def device_ms_by_kernel(fn) -> dict:
    """Device milliseconds per kernel name over one ``fn()`` call, from
    ``torch.profiler`` (empty if the profiler records no device activity).
    The program's ranges are skipped (:func:`device_ops`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in device_ops(prof.key_averages()):
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        out[evt.key] = out.get(evt.key, 0.0) + us / 1e3
    return out


def device_events(fn) -> list:
    """``[(name, device ms)]`` of every device activity (kernels, copies)
    of one ``fn()`` call after one warm-up call, in order, from
    ``torch.profiler``; the program's ranges are skipped."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us() / 1e3)
            for e in device_ops(prof.events())]


def device_ms_per_call(fn, name_part: str, reps: int = REPS):
    """Median device milliseconds of the kernels whose name holds
    ``name_part``, one per ``fn()`` call over ``reps`` calls after two
    warm-up calls, from ``torch.profiler``; None if the profiler records
    no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in device_ops(prof.events())
          if name_part in e.name]
    return statistics.median(us) / 1e3 if us else None


def device_ms_total(fn, reps: int = REPS):
    """Device milliseconds of every kernel ``fn()`` launches, per call, over
    ``reps`` calls (``torch.profiler``; None if it records none)."""
    by_kernel = device_ms_by_kernel(lambda: [fn() for _ in range(reps)])
    return sum(by_kernel.values()) / reps if by_kernel else None


def _sm_count() -> int:
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def bf16_ulp(x):
    """One bf16 ulp at each element of ``x`` (0 where ``x`` is 0)."""
    import torch

    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)
    return torch.where(x != 0, ulp, 0.0)


def bf16_ulp_err(out, ref) -> tuple[float, float]:
    """``(max_abs, ulps)`` of ``out`` against ``ref``: the max abs
    difference, and the max over elements of ``(|out - ref| - BF16_ATOL)``
    in bf16 ulps of ``ref``, which the ulp bound holds at BF16_ULPS."""
    d = (out.float() - ref.float()).abs()
    excess = (d - BF16_ATOL) / bf16_ulp(ref)       # inf: beyond at ref 0
    return float(d.max()), float(excess.nan_to_num(nan=0.0).max()
                                 .clamp(min=0))


def bound_ms(n_bytes: float, n_ops: float, ops_s: float = F32_OPS_S
             ) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / ops_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ===========================================================================
# phase 1: the build, and the tensor-core instructions of the attention
# kernels
# ===========================================================================

#: Attention kernels in the library, by function name (the bf16 B4, B5 and
#: B6 are the ``_mma`` ones).
ATTN_KERNELS = re.compile(r"(flash_attention_(?:fwd|dq|dkv)(?:_mma)?_kernel"
                          r"|gqa_decode_kernel)")
#: Kernels whose bf16 instantiation must run its products on the tensor
#: cores, and whose float32 one must not.
TENSOR_CORE_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                       "flash_attention_dkv")
#: B8's launches that run products, and the SSD backward's, each compiled
#: for N = 64 and 128 (ssd_bwd_dcb_kernel once: it reads no N-wide
#: operand): every instantiation must run them on the tensor cores, and
#: each one's float32 small-head version (P = N = 16) none.
SSD_PRODUCT_KERNELS = ("ssd_cb_kernel", "ssd_states_kernel",
                       "ssd_output_kernel", "ssd_bwd_cb_kernel",
                       "ssd_bwd_dstate_kernel", "ssd_bwd_dx_kernel",
                       "ssd_bwd_dcb_kernel", "ssd_bwd_dbc_kernel")


def hmma_by_function(lib_path: str) -> dict:
    """``{mangled function name: n}``: tensor-core instructions (``HMMA``,
    ``HGMMA``) in the SASS of each kernel of the library, from the
    toolkit's ``cuobjdump -sass``."""
    from repro_torch.kernels._build import find_nvcc

    cuobjdump = str(Path(find_nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            counts[current] = 0
        elif current is not None and re.search(r"\bH(?:G)?MMA\b", line):
            counts[current] += 1
    return counts


def tensor_core_counts(by_function: dict) -> dict:
    """``{(kernel, dtype, hd): n}`` for each attention kernel instantiation
    of :func:`hmma_by_function`'s counts."""
    counts = {}
    for name, n in by_function.items():
        m = ATTN_KERNELS.search(name)
        hd = re.search(r"Li(\d+)E", name)
        if m and hd:
            base = m.group(1)
            dtype = ("bf16" if "_mma_" in base or "bfloat16" in name
                     else "f32")
            counts[(base.replace("_mma", ""), dtype, int(hd.group(1)))] = n
    return counts


def phase_build() -> None:
    """Build the library; print ptxas's register, shared-memory and spill
    lines and each attention and SSD kernel's tensor-core instruction
    count; check that the bf16 B4, B5 and B6 have some and their float32
    versions none, and that B8's and the SSD backward's product kernels
    have some at N = 64 and 128 and their small-head versions none."""
    from repro_torch.kernels._build import load_library

    _, info = load_library()
    log(f"  library {info['path']} built={info['built']} in "
        f"{info['build_s']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())
    by_function = hmma_by_function(info["path"])
    counts = tensor_core_counts(by_function)
    for (base, dtype, hd), n in sorted(counts.items()):
        log(f"  SASS {base} {dtype} hd={hd}: {n} HMMA/HGMMA")
    for base in TENSOR_CORE_KERNELS:
        dims = [16, 32, 64, 80, 128]
        for dtype in ("bf16", "f32"):
            got = {hd: n for (b, d, hd), n in counts.items()
                   if b == base + "_kernel" and d == dtype}
            want_some = dtype == "bf16"
            check(sorted(got) == dims
                  and all((n > 0) == want_some for n in got.values()),
                  f"{base} {dtype} tensor-core instructions {got}")
    for base in SSD_PRODUCT_KERNELS:
        got = {int(m.group(1)) if (m := re.search(r"Li(\d+)E", name))
               else 0: n for name, n in by_function.items() if base in name}
        log(f"  SASS {base} N={sorted(got)}: {list(got.values())} "
            "HMMA/HGMMA")
        want = [0] if base == "ssd_bwd_dcb_kernel" else [64, 128]
        check(sorted(got) == want and all(got.values()),
              f"{base} tensor-core instructions {got}")
        # the float32 small-head version, P = N = 16, runs no product on
        # the tensor cores
        small = base.replace("_kernel", "_small_kernel")
        got = {name: n for name, n in by_function.items() if small in name}
        log(f"  SASS {small}: {list(got.values())} HMMA/HGMMA")
        check(len(got) == 1 and not any(got.values()),
              f"{small} tensor-core instructions {got}")


# ===========================================================================
# phase 2: kernels vs plain versions
# ===========================================================================

def _qos_inputs(U, P, seed, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = np.float32
    host = [rng.uniform(0, 1, U).astype(f32), rng.uniform(0, 10, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32),
            rng.integers(0, 100, U).astype(np.int32),
            rng.uniform(0, 1, P).astype(f32), rng.uniform(1, 30, P).astype(f32),
            rng.uniform(1, 30, P).astype(f32),
            rng.integers(0, 100, P).astype(np.int32)]
    return [torch.from_numpy(a).to(dev) for a in host]


def _cand_inputs(U, K, seed, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = np.float32
    host = [rng.uniform(0, 1, U).astype(f32), rng.uniform(0, 10, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32),
            rng.uniform(0, 1, (U, K)).astype(f32),
            rng.uniform(1, 30, (U, K)).astype(f32),
            rng.uniform(1, 30, (U, K)).astype(f32),
            (rng.random((U, K)) < 0.8).astype(f32)]
    return [torch.from_numpy(a).to(dev) for a in host]


def _argmax_inputs(E, P, seed, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    v = rng.normal(size=(E, P)).astype(np.float32)   # negative benefits too
    v[:, ::3] = np.round(v[:, ::3])                  # exact ties
    m = rng.random((E, P)) < 0.5
    m[::7] = False                                   # empty rows
    return torch.from_numpy(v).to(dev), torch.from_numpy(m).to(dev)


def _argmax_edge_case(dev):
    import torch

    v = torch.tensor([[1.0, 3.0, 3.0, -2.0], [-5.0, -1.0, -9.0, -1.0],
                      [7.0, 8.0, 9.0, 10.0], [0.0, 0.0, 0.0, 0.0]],
                     device=dev)
    m = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 1], [0, 0, 0, 0], [0, 1, 0, 1]],
                     dtype=torch.bool, device=dev)
    return v, m


def _topk_inputs(U, M, seed, dev, S=100, ties=False, empty_service=False):
    """Users, an impl table [S, M] (each service 1..M implementations, -1
    padded; with ``empty_service`` the last service has none) and the
    models' attributes, in topk_candidates' argument order. With ``ties``
    the model records repeat three values, so a user's QoS ties across
    implementations."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = np.float32
    counts = rng.integers(1, M + 1, S)
    counts[0] = M
    if empty_service:
        counts[-1] = 0
    P = int(counts.sum())
    table = np.full((S, M), -1, np.int32)
    perm = rng.permutation(P).astype(np.int32)
    start = 0
    for s, c in enumerate(counts):
        table[s, :c] = np.sort(perm[start:start + c])
        start += c
    if ties:
        base = rng.integers(0, 3, P)
        models = [np.array(v, f32)[base] for v in
                  ((0.3, 0.6, 0.9), (5.0, 15.0, 25.0), (5.0, 15.0, 25.0))]
    else:
        models = [rng.uniform(0, 1, P).astype(f32),
                  rng.uniform(1, 30, P).astype(f32),
                  rng.uniform(1, 30, P).astype(f32)]
    host = [rng.integers(0, S, U).astype(np.int32),
            rng.uniform(0, 1, U).astype(f32), rng.uniform(0, 10, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32), table] + models
    return [torch.from_numpy(a).to(dev) for a in host]


def _topk_main_inputs(inst, dev):
    """The main path's candidate-build inputs for ``inst``."""
    import numpy as np
    import torch

    from repro_torch.core import TorchInstance, impl_table_np

    ti = TorchInstance.from_pies(inst, dev)
    table = torch.from_numpy(
        impl_table_np(inst.sm_service, inst.S).astype(np.int32)).to(dev)
    return [ti.u_service, ti.u_alpha, ti.u_delta, ti.u_share_k, ti.u_share_w,
            table, ti.sm_acc, ti.sm_k, ti.sm_w]


def phase_kernels(dev, main) -> dict:
    """Each kernel vs its plain version; returns per-kernel numbers at the
    main path's shapes (``main``: the main path's instance)."""
    import torch

    from repro_torch.core import max_impls_of
    from repro_torch.kernels.qos_matrix import ops, ref

    dm = 10.0
    main_P, main_K = main.P, max_impls_of(main)
    out = {}

    # --- B1 qos_matrix -----------------------------------------------------
    # ragged shapes: U * P not a multiple of the kernel's 4-element groups,
    # P below 4, one user; the route's OMS argmax needs equal bits
    err = 0.0
    for U, P, seed in ((1, 1, 0), (37, 5, 1), (513, 257, 3), (1, 3, 5),
                       (7, 1, 6), (5, 3, 7), (1, main_P, 8),
                       (1001, main_P, 9), (U_MAIN, main_P, 4)):
        args = _qos_inputs(U, P, seed, dev)
        k = ops.qos_matrix_cuda(*args, delta_max=dm)
        p = ref.qos_matrix_ref(*args, delta_max=dm)
        torch.cuda.synchronize()
        e = float((k - p).abs().max())
        same = torch.equal(k, p)
        log(f"  qos_matrix [{U}, {P}]: max_abs_err={e:.3g}, "
            f"{'equal bits' if same else 'bits differ'}")
        check(e <= QOS_TOL, f"qos_matrix [{U}, {P}] err {e}")
        check(same, f"qos_matrix [{U}, {P}] not bit-equal to the plain "
              "version")
        err = max(err, e)
        del k, p
    ms = time_ms(lambda: ops.qos_matrix_cuda(*args, delta_max=dm))
    plain = time_ms(lambda: ref.qos_matrix_ref(*args, delta_max=dm))
    n_bytes = U * P * 4 + U * 5 * 4 + P * 4 * 4
    b, by = bound_ms(n_bytes, 18 * U * P)
    out["qos_matrix"] = dict(shape=[U, P], max_abs_err=err, ms=ms,
                             plain_ms=plain, bound_ms=b, bound_by=by,
                             library_ms=None,
                             note="persistent grid, 16-byte streaming "
                                  "stores; bit-equal to the plain version")
    del args
    torch.cuda.empty_cache()

    # --- B2, the pre-gathered kernel (held, off the main path) -------------
    err = 0.0
    for U, K, seed in ((1, 1, 0), (300, 7, 1), (257, 10, 2),
                       (U_MAIN, main_K, 4)):
        args = _cand_inputs(U, K, seed, dev)
        k = ops.qos_candidates_cuda(*args, delta_max=dm)
        p = ref.qos_candidates_ref(*args, delta_max=dm)
        torch.cuda.synchronize()
        e = float((k - p).abs().max())
        log(f"  qos_candidates (pre-gathered) [{U}, {K}]: max_abs_err={e:.3g}")
        check(e <= QOS_TOL, f"qos_candidates [{U}, {K}] err {e}")
        check(not bool(k[args[7] == 0].any()), "invalid pairs must be 0")
        err = max(err, e)
    gathered_ms = time_ms(lambda: ops.qos_candidates_cuda(*args, delta_max=dm))
    log(f"  qos_candidates (pre-gathered) [{U}, {K}]: kernel "
        f"{gathered_ms:.4f} ms")
    del args

    # --- B2 on the main path: the fused candidate build ---------------------
    # cand_idx equal and cand_q bit-equal to the plain version, and two
    # calls bit-equal, at: one user and one slot, k < M, k = M, -1 padding
    # with a service that has no implementation, QoS ties at k < M, and the
    # main path's instance
    err = 0.0
    cases = [(f"[{U}, {M}] k={k}{' ' + tag if tag else ''}", k,
              _topk_inputs(U, M, seed, dev, **opts), dm)
             for U, M, k, seed, opts, tag in (
                 (1, 1, None, 0, {}, ""), (300, 7, 3, 1, {}, ""),
                 (257, 10, 10, 2, {}, ""),
                 (200, 10, 4, 3, dict(empty_service=True),
                  "(a service without implementations)"),
                 (300, 10, 4, 4, dict(ties=True), "(QoS ties)"),
                 (5003, 16, 5, 5, dict(S=4000),
                  "(table and models over shared memory: read through L2)"))]
    cases.append((f"[{main.U}, {main_K}] k={main_K} (main path)", None,
                  _topk_main_inputs(main, dev), float(main.delta_max)))
    for name, kk, args, dmax in cases:
        before = ops.LAUNCHES["qos_candidates"]
        ki, kq = ops.topk_candidates_cuda(*args, kk, delta_max=dmax)
        check(ops.LAUNCHES["qos_candidates"] == before + 1,
              f"topk_candidates {name}: one launch a build")
        pi, pq = ref.topk_candidates_ref(*args, kk, delta_max=dmax)
        ki2, kq2 = ops.topk_candidates_cuda(*args, kk, delta_max=dmax)
        torch.cuda.synchronize()
        e = float((kq - pq).abs().max()) if kq.numel() else 0.0
        same = torch.equal(ki, pi) and torch.equal(kq, pq)
        log(f"  topk_candidates {name}: cand_idx "
            f"{'equal' if torch.equal(ki, pi) else 'differs'}, cand_q "
            f"{'equal bits' if torch.equal(kq, pq) else 'bits differ'} "
            f"(max_abs_err={e:.3g}), rerun "
            f"{'bit-equal' if torch.equal(ki2, ki) and torch.equal(kq2, kq) else 'differs'}")
        check(same, f"topk_candidates {name} not equal to the plain version")
        check(torch.equal(ki2, ki) and torch.equal(kq2, kq),
              f"topk_candidates {name}: two calls differ")
        err = max(err, e)
        del ki, kq, pi, pq, ki2, kq2
    U, kk = main.U, main_K
    ms = time_ms(lambda: ops.topk_candidates_cuda(*args, delta_max=dmax))
    plain = time_ms(lambda: ref.topk_candidates_ref(*args, delta_max=dmax))
    dev_ms = device_ms_per_call(
        lambda: ops.topk_candidates_cuda(*args, delta_max=dmax),
        "topk_candidates_kernel")
    # each user's service and four attributes read once, each kept slot's
    # (index, QoS) written once; qos_pair is about 17 operations a pair
    b, by = bound_ms(20 * U + 8 * U * kk, 17 * U * kk)
    out["qos_candidates"] = dict(
        shape=[U, kk], max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=None, device_ms=dev_ms,
        note=f"fused candidate build (topk_candidates_kernel), one launch; "
             f"the pre-gathered qos_candidates_kernel {gathered_ms:.4f} ms "
             f"at [{U_MAIN}, {main_K}] on gathered inputs")
    log(f"  topk_candidates device time (torch.profiler, median per call): "
        f"{dev_ms} ms")
    del args

    # --- B3 greedy_argmax ---------------------------------------------------
    err = 0.0
    cases = [_argmax_edge_case(dev)] + [
        _argmax_inputs(E, P, seed, dev)
        for E, P, seed in ((1, 1, 0), (3, 33, 1), (40, 400, 3),
                           (E_MAIN, main_P, 4))]
    for v, m in cases:
        bk, ik = ops.greedy_argmax_cuda(v, m)
        bp, ip = ref.greedy_argmax_ref(v, m)
        torch.cuda.synchronize()
        check(torch.equal(ik, ip), f"greedy_argmax idx {tuple(v.shape)}")
        e = float((bk - bp).abs().max())
        log(f"  greedy_argmax {list(v.shape)}: idx exact, "
            f"max_abs_err={e:.3g}")
        check(e == 0.0, f"greedy_argmax best {tuple(v.shape)} err {e}")
        err = max(err, e)
    check(ops.greedy_argmax_cuda(*cases[0])[1].tolist() == [1, 1, -1, 1],
          "greedy_argmax ties, negatives and empty rows")
    v, m = cases[-1]
    E, P = v.shape
    ms = time_ms(lambda: ops.greedy_argmax_cuda(v, m))
    plain = time_ms(lambda: ref.greedy_argmax_ref(v, m))
    premasked = torch.where(m, v, -1e30)
    lib = time_ms(lambda: torch.max(premasked, dim=1))
    # the event times above hold the host's dispatch as much as the kernel:
    # the kernels' own device time, median per call
    dev_ms = device_ms_per_call(lambda: ops.greedy_argmax_cuda(v, m),
                                "greedy_argmax_kernel")
    lib_dev_ms = device_ms_per_call(lambda: torch.max(premasked, dim=1),
                                    "reduce")
    b, by = bound_ms(E * P * 4 + E * P + E * 8, 2 * E * P)
    out["greedy_argmax"] = dict(shape=[E, P], max_abs_err=err, ms=ms,
                                plain_ms=plain, bound_ms=b, bound_by=by,
                                library_ms=lib, device_ms=dev_ms,
                                library_device_ms=lib_dev_ms)
    for name, r in out.items():
        log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms']}")
    log(f"  greedy_argmax device time (torch.profiler, median per call): "
        f"kernel {dev_ms} ms, torch.max's reduction {lib_dev_ms} ms")
    return out


# ===========================================================================
# phases 3–5: the main path
# ===========================================================================

def phase_main_path(dev, inst) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import (CandidateSet, TorchInstance,
                                  egp_place_sparse_torch, impl_table_np,
                                  sigma_sparse_np)
    from repro_torch.kernels.qos_matrix import ops
    from repro_torch.serving import Router
    from repro_torch.workloads import evaluate_sparse

    # the main path: one sparse tick and one dense route, counted
    router = Router(device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    vals, xs = evaluate_sparse([inst], device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decision = router.route(inst, placement=xs[0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    log(f"  main path launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    sigma, x = float(vals[0]), xs[0]
    log(f"  tick (cold) {1e3 * (t1 - t0):.1f} ms, route (cold) "
        f"{1e3 * (t2 - t1):.1f} ms, sigma={sigma!r}, "
        f"placed={int(x.sum())}")

    # the same tick with the plain versions: the same decisions
    t0 = time.perf_counter()
    pvals, pxs = evaluate_sparse([inst], device=dev, use_kernel=False)
    torch.cuda.synchronize()
    plain_tick = 1e3 * (time.perf_counter() - t0)
    check(torch.equal(pxs[0], x), "plain tick x differs from kernel tick x")
    rel = abs(float(pvals[0]) - sigma) / sigma
    check(rel <= 1e-6, f"plain tick sigma rel diff {rel}")

    # a second kernel tick: bit-identical (fixed-order scatter sums)
    t0 = time.perf_counter()
    vals2, xs2 = evaluate_sparse([inst], device=dev)
    torch.cuda.synchronize()
    warm_tick = 1e3 * (time.perf_counter() - t0)
    check(torch.equal(xs2[0], x), "second kernel tick x differs")
    check(float(vals2[0]) == sigma, "second kernel tick sigma differs")
    log(f"  tick warm {warm_tick:.1f} ms (plain versions {plain_tick:.1f} "
        f"ms); x identical, sigma plain rel diff {rel:.3g}, rerun bit-equal")

    # loop iterations == greedy_argmax launches; σ vs float64 host
    t0 = time.perf_counter()
    ti = TorchInstance.from_pies(inst, dev)
    table = torch.from_numpy(
        impl_table_np(inst.sm_service, inst.S).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    upload_ms = 1e3 * (time.perf_counter() - t0)
    ops.reset_launch_counts()
    cand_idx, cand_q = ops.qos_candidates_from_instance(ti, table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x3, iters = egp_place_sparse_torch(cand_idx, cand_q, ti.u_edge,
                                       ti.sm_service, ti.sm_r, ti.R,
                                       max_iters=inst.P + 1)
    torch.cuda.synchronize()
    egp_ms = 1e3 * (time.perf_counter() - t0)
    check(torch.equal(x3, x), "direct egp x differs")
    check(launches["greedy_argmax"] == iters == ops.LAUNCHES["greedy_argmax"],
          f"greedy_argmax launches {launches['greedy_argmax']} vs "
          f"{iters} iterations")
    cs = CandidateSet(cand_idx=cand_idx.cpu().numpy().astype(np.int64),
                      cand_q=cand_q.cpu().numpy().astype(np.float64),
                      k=int(cand_idx.shape[1]), exact=True)
    x_np = x.cpu().numpy()
    host_sigma = sigma_sparse_np(inst, x_np, cs)
    rel64 = abs(sigma - host_sigma) / host_sigma
    check(rel64 <= 1e-5, f"sigma vs float64 host rel {rel64}")
    t0 = time.perf_counter()
    cand_idx, cand_q = ops.qos_candidates_from_instance(ti, table)
    torch.cuda.synchronize()
    cand_ms = 1e3 * (time.perf_counter() - t0)
    log(f"  greedy iterations {iters} (= greedy_argmax launches); egp loop "
        f"{egp_ms:.1f} ms = {egp_ms / max(iters, 1):.3f} ms/iteration; "
        f"instance upload + impl table {upload_ms:.1f} ms; candidate build "
        f"{cand_ms:.2f} ms; sigma vs float64 host rel {rel64:.3g}")
    # the build's device work (torch.profiler): the one fused kernel and
    # nothing else, the impl table being on the card already
    before = ops.LAUNCHES["qos_candidates"]
    ops.qos_candidates_from_instance(ti, table)
    cand_launches = ops.LAUNCHES["qos_candidates"] - before
    events = device_events(
        lambda: ops.qos_candidates_from_instance(ti, table))
    cand_kernels = [n for n, _ in events
                    if not n.startswith(("Memcpy", "Memset"))]
    cand_dev_ms = sum(t for _, t in events)
    log(f"  candidate build: host {cand_ms:.3f} ms, device {cand_dev_ms:.4f} "
        f"ms, {cand_launches} launch(es); device kernels {cand_kernels}, "
        f"{len(events) - len(cand_kernels)} copies")
    check(cand_launches == 1, f"candidate build launches {cand_launches}")
    check(len(cand_kernels) == 1
          and "topk_candidates_kernel" in cand_kernels[0],
          f"candidate build device kernels {cand_kernels}")

    # where the greedy loop's device time goes (torch.profiler kernel times)
    by_kernel = device_ms_by_kernel(lambda: egp_place_sparse_torch(
        cand_idx, cand_q, ti.u_edge, ti.sm_service, ti.sm_r, ti.R,
        max_iters=inst.P + 1))
    busy = sum(by_kernel.values())
    b3_ms = sum(t for k, t in by_kernel.items() if "greedy_argmax" in k)
    log(f"  egp loop device busy {busy:.1f} ms of {egp_ms:.1f} ms wall "
        f"({100 * busy / egp_ms:.1f} %, {len(by_kernel)} kernel names); "
        f"B3 greedy_argmax {b3_ms:.3f} ms of it "
        f"({100 * b3_ms / max(busy, 1e-9):.2f} %, "
        f"{1e3 * b3_ms / max(iters, 1):.2f} us per iteration)")
    for name, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {t:9.3f} ms  {name[:90]}")
    del ti, cand_idx, cand_q, x3

    # phase 4: routing at full size
    route_rel = abs(decision.value - sigma) / sigma
    check(decision.assignment.shape == (inst.U,), "route assignment shape")
    check(np.isfinite(decision.expected_qos).all(), "route qos finite")
    check(route_rel <= 1e-5, f"route value vs sparse sigma rel {route_rel}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decision2 = router.route(inst, placement=x)
    torch.cuda.synchronize()
    route_warm = 1e3 * (time.perf_counter() - t0)
    check(np.array_equal(decision2.assignment, decision.assignment),
          "route is deterministic")
    log(f"  route warm {route_warm:.1f} ms; value={decision.value!r}, "
        f"rel vs sparse sigma {route_rel:.3g}, served "
        f"{int((decision.assignment >= 0).sum())}/{inst.U}")
    del decision, decision2
    torch.cuda.empty_cache()
    return dict(launches=launches, iterations=iters, sigma=sigma,
                warm_tick_ms=warm_tick, plain_tick_ms=plain_tick,
                egp_ms=egp_ms, cand_ms=cand_ms, cand_device_ms=cand_dev_ms,
                cand_launches=cand_launches, cand_kernels=cand_kernels,
                upload_ms=upload_ms,
                route_warm_ms=route_warm, loop_busy_ms=busy,
                loop_b3_ms=b3_ms, x=x.cpu())


def phase_paper_scale(dev) -> dict:
    """Paper-scale instances: the sparse tick and Router.place (EGP, AGP,
    OPT) against the host oracles; EGP's ratio to OPT is logged."""
    import numpy as np

    from repro_torch.core import (agp_np, egp_np, opt_np, qos_matrix_np,
                                  realworld_instance, sigma_np,
                                  synthetic_instance)
    from repro_torch.serving import Router
    from repro_torch.workloads import evaluate_host, evaluate_sparse

    cases = [(f"synthetic(2000, 10, seed={s})",
              synthetic_instance(2000, n_edges=10, seed=s)) for s in (0, 1, 2)]
    cases.append(("realworld(300)", realworld_instance(300)))
    ratios = {}
    for name, inst in cases:
        vals, _ = evaluate_sparse([inst], device=dev)
        host = float(evaluate_host([inst])[0])
        diff = abs(float(vals[0]) - host)
        check(diff <= 1e-4, f"{name}: sparse sigma vs host diff {diff}")
        Q = qos_matrix_np(inst)
        x_host = egp_np(inst, Q)
        x_card = Router(device=dev).place(inst)
        pdiff = abs(sigma_np(inst, x_card, Q) - sigma_np(inst, x_host, Q))
        check(pdiff <= 1e-4, f"{name}: Router.place sigma diff {pdiff}")
        log(f"  {name}: sigma card {float(vals[0])!r} host {host!r} "
            f"(diff {diff:.3g}); Router.place x "
            f"{'equal to' if np.array_equal(x_card, x_host) else 'differs from'}"
            f" host egp_np, sigma diff {pdiff:.3g}")
        s_agp = sigma_np(inst, agp_np(inst, Q), Q)
        x_card = Router(placement_algo="agp", device=dev).place(inst)
        adiff = abs(sigma_np(inst, x_card, Q) - s_agp)
        check(adiff <= 1e-4, f"{name}: Router(agp).place sigma diff {adiff}")
        t0 = time.perf_counter()
        s_opt = sigma_np(inst, opt_np(inst, Q), Q)
        opt_s = time.perf_counter() - t0
        if opt_s > OPT_HOST_LIMIT_S:
            log(f"  {name}: opt_np took {opt_s:.1f} s on the host, over "
                f"{OPT_HOST_LIMIT_S} s: dropped from the OPT check")
            continue
        x_card = Router(placement_algo="opt", device=dev).place(inst)
        odiff = abs(sigma_np(inst, x_card, Q) - s_opt)
        check(odiff <= 1e-4, f"{name}: Router(opt).place sigma diff {odiff}")
        ratios[name] = dict(egp=sigma_np(inst, x_host, Q) / s_opt,
                            agp=s_agp / s_opt)
        log(f"  {name}: Router agp sigma diff {adiff:.3g}, opt sigma diff "
            f"{odiff:.3g} (opt_np {opt_s:.2f} s on the host); EGP/OPT "
            f"{ratios[name]['egp']!r}, AGP/OPT {ratios[name]['agp']!r}")
    mean = float(np.mean([r["egp"] for r in ratios.values()]))
    log(f"  EGP/OPT over {len(ratios)} cases: mean {mean!r} (logged, not "
        "gated; the paper reports 0.904 on average)")
    return dict(opt_ratios=ratios, egp_opt_mean=mean)


def _same_x(a, b) -> bool:
    """Equal placements: tensors, or lists of them (a bucketed batch's)."""
    import torch

    if isinstance(a, list):
        return len(a) == len(b) and all(torch.equal(p, q)
                                        for p, q in zip(a, b))
    return torch.equal(a, b)


def phase_batched(dev) -> dict:
    """The dense batched path: the reference benchmark's mixed-size batch
    (benchmarks/placement_scale.py's bucket mix at U0 users) through
    evaluate_batch, bucketed and globally padded, for EGP and AGP."""
    import numpy as np
    import torch

    from repro_torch.core import synthetic_instance
    from repro_torch.kernels.qos_matrix import ops
    from repro_torch.workloads import (bucket_instances, evaluate_batch,
                                       evaluate_host, pad_instances)

    U0 = BATCH_U0
    mix = [synthetic_instance(n_users=max(8, U0 // (2 ** i)),
                              n_edges=max(4, (U0 // (2 ** i)) // 1000),
                              seed=i) for i in range(4)]
    mi = max(i.P for i in mix) + 1
    log(f"  mix (U, P, E): {[(i.U, i.P, i.E) for i in mix]}, "
        f"max_iters {mi}")
    out = {}
    for algo in ("egp", "agp"):
        t0 = time.perf_counter()
        host = evaluate_host(mix, algo)
        host_s = time.perf_counter() - t0
        for kind, make in (("bucketed", bucket_instances),
                           ("padded", pad_instances)):
            batch = make(mix, device=dev)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            vals, x = evaluate_batch(batch, algo, max_iters=mi)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            launches = dict(ops.LAUNCHES)
            check(launches["qos_matrix"] > 0 and launches["greedy_argmax"] > 0,
                  f"batched {algo} {kind}: B1/B3 launches {launches}")
            diff = float(np.abs(vals - host).max())
            check(diff <= BATCH_ATOL,
                  f"batched {algo} {kind}: values vs host diff {diff}")
            t0 = time.perf_counter()
            pvals, px = evaluate_batch(batch, algo, max_iters=mi,
                                       use_kernel=False)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            check(_same_x(px, x), f"batched {algo} {kind}: plain x differs")
            vals2, x2 = evaluate_batch(batch, algo, max_iters=mi)
            torch.cuda.synchronize()
            check(_same_x(x2, x) and np.array_equal(vals2, vals),
                  f"batched {algo} {kind}: rerun differs")
            log(f"  evaluate_batch {algo} {kind}: {ms:.1f} ms (plain "
                f"versions {plain_ms:.1f} ms; host {1e3 * host_s:.1f} ms), "
                f"values {vals.tolist()}, max diff vs host {diff:.3g}; x "
                f"identical with the plain versions and on a rerun; "
                f"launches {launches}")
            out[f"{algo}_{kind}"] = dict(ms=ms, plain_ms=plain_ms,
                                         host_ms=1e3 * host_s, diff=diff,
                                         launches=launches)
            del batch, x, px, x2
    torch.cuda.empty_cache()
    return out


# ===========================================================================
# phase 13: the sweep engine
# ===========================================================================

def _span_totals(tracer) -> dict:
    """Seconds in each span name, and the items and seconds of the
    sweep.chunk spans by executor, from a tracer's snapshot."""
    doc = tracer.snapshot()
    totals, by_exec = {}, {}
    spans = doc["spans"]
    for row, (nid, t0, t1) in enumerate(zip(spans["name"], spans["t0_ns"],
                                            spans["t1_ns"])):
        name = doc["names"][nid]
        totals[name] = totals.get(name, 0.0) + (t1 - t0) / 1e9
        args = doc["span_args"].get(str(row), {})
        if name == "sweep.chunk":
            items, secs = by_exec.get(args["executor"], (0, 0.0))
            by_exec[args["executor"]] = (items + args["items"],
                                         secs + (t1 - t0) / 1e9)
    return dict(totals=totals, by_executor=by_exec)


def _sweep_check(spec, result, host_of: dict, what: str) -> float:
    """Every accelerator column of ``result`` within SWEEP_ATOL of the
    host path (``host_of[(variant, algo)]``); returns the largest
    difference."""
    import numpy as np

    worst = 0.0
    for (variant, algo), host in host_of.items():
        got = result.values[(variant, algo)].ravel()
        check(not np.isnan(got).any(), f"{what}: {variant}/{algo} incomplete")
        diff = float(np.abs(got - host).max())
        check(diff <= SWEEP_ATOL,
              f"{what}: {variant}/{algo} accel vs host diff {diff}")
        worst = max(worst, diff)
    return worst


def _host_columns(spec) -> dict:
    """egp_np/agp_np + sigma_np of every accelerator group's items."""
    from repro_torch.sweeps import materialize, variant_key
    from repro_torch.workloads import evaluate_host

    out = {}
    for (scenario, overrides, algo), items in spec.groups():
        if spec.executor_of(algo) != "accel":
            continue
        insts = materialize(scenario, overrides,
                            [(it.seed, it.tick) for it in items])
        out[(variant_key(scenario, overrides), algo)] = evaluate_host(
            insts, algo=algo)
    return out


def _same_values(a, b) -> bool:
    return a.values.keys() == b.values.keys() and all(
        a.values[k].tobytes() == b.values[k].tobytes() for k in a.values)


def phase_sweeps(dev) -> dict:
    """The port's run_sweep on the card: Fig. 3 at the paper's widths, the
    10^4-user generator, every registered scenario, resume and chunking,
    and the plain versions of B1 and B3."""
    import dataclasses

    import torch

    from repro_torch import obs
    from repro_torch.kernels.qos_matrix import ops
    from repro_torch.sweeps import (SweepSpec, envelope_for, fig3_table,
                                    materialize, run_sweep, table)
    from repro_torch.workloads import (bucket_instances, evaluate_batch,
                                       list_scenarios)

    out = {}
    accel = ("egp", "agp")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        store = Path(tmp)

        # --- 1. Fig. 3 at the §VI-B widths: the main path, counted --------
        fig3 = SweepSpec(scenarios=("synthetic",),
                         override_grid=({"n_users": SWEEP_FIG3_USERS},),
                         algos=("egp", "agp", "sck", "rnd", "opt"),
                         seeds=range(SWEEP_FIG3_SEEDS))
        tracer = obs.enable()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_sweep(fig3, store / "fig3", device=dev)
        torch.cuda.synchronize()
        fig3_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        log(f"  fig3 sweep: {fig3_s:.2f} s, execution {res.execution}, "
            f"launches {launches}")
        n_accel = 2 * SWEEP_FIG3_SEEDS
        check(launches["qos_matrix"] >= n_accel
              and launches["greedy_argmax"] >= n_accel,
              f"fig3 sweep: B1/B3 launches {launches} for {n_accel} items")
        check(res.complete and res.execution["backend"] == dev.type
              and res.execution["path"] == "batched",
              f"fig3 sweep execution {res.execution}")
        host = _host_columns(fig3)
        diff = _sweep_check(fig3, res, host, "fig3")
        cpu = run_sweep(fig3, device="cpu")
        for (variant, algo), vals in res.values.items():
            if fig3.executor_of(algo) == "host":
                check(vals.tobytes() == cpu.values[(variant,
                                                    algo)].tobytes(),
                      f"fig3: host column {algo} differs on a CPU run")
        variant = f"synthetic[n_users={SWEEP_FIG3_USERS}]"
        ratio = res.values[(variant, "egp")] / res.values[(variant, "opt")]
        log("  fig3_table:\n" + fig3_table(res))
        log(f"  accel vs host max diff {diff:.3g}; host columns "
            f"bit-identical to a CPU run; EGP/OPT per seed "
            f"{ratio.ravel().tolist()}, mean {float(ratio.mean())!r} "
            "(logged, not gated; the paper reports 0.904)")
        out["fig3"] = dict(s=fig3_s, launches=launches, diff=diff,
                           egp_opt_mean=float(ratio.mean()),
                           **_span_totals(tracer))

        # --- 5. the plain versions of B1 and B3: bit-identical ------------
        # the sweep's buckets (each instance's envelope, capped by the
        # row's), evaluated at once: an item's value does not depend on
        # its batch neighbours
        (overrides,) = fig3.override_grid
        insts = materialize("synthetic", overrides,
                            [(s, 0) for s in fig3.seeds])
        t0 = time.perf_counter()
        batch = bucket_instances(
            insts, cap=envelope_for("synthetic", overrides), device=dev)
        for algo in accel:
            plain, _ = evaluate_batch(batch, algo, max_iters=fig3.max_iters,
                                      use_kernel=False)
            check(plain.tobytes() == res.values[(variant, algo)].tobytes(),
                  f"fig3 {algo}: plain versions of B1/B3 differ")
        plain_s = time.perf_counter() - t0
        log(f"  fig3 accel rows with the plain versions of B1/B3: "
            f"bit-identical ({plain_s:.2f} s)")

        # --- 2. full width: 10^4 users, one-item chunks -------------------
        full = SweepSpec(scenarios=("synthetic",),
                         override_grid=({"n_users": SWEEP_FULL_USERS},),
                         algos=accel, seeds=range(SWEEP_FULL_SEEDS))
        tracer = obs.enable()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_sweep(full, store / "full", device=dev)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        check(res.execution["chunks_computed"] == 2 * SWEEP_FULL_SEEDS,
              f"full width: chunks {res.execution}")
        t0 = time.perf_counter()
        host = _host_columns(full)
        host_s = time.perf_counter() - t0
        diff = _sweep_check(full, res, host, "full width")
        spans = _span_totals(tracer)
        rates = {ex: items / secs for ex, (items, secs)
                 in spans["by_executor"].items()}
        one = SweepSpec(scenarios=("synthetic",),
                        override_grid=({"n_users": SWEEP_FULL_USERS},),
                        algos=("egp",), seeds=(SWEEP_FULL_SEEDS,))
        run_sweep(one, device=dev)             # warm: its re-run is done
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        item = run_sweep(one, device=dev)
        torch.cuda.synchronize()
        one_launches = dict(ops.LAUNCHES)
        check(one_launches["qos_matrix"] == 1
              and 1 <= one_launches["greedy_argmax"] <= one.max_iters,
              f"one 10^4-user item: launches {one_launches}")
        # device time by kernel, per item, over three warm items
        reps = 3
        by_kernel = {k: v / reps for k, v in device_ms_by_kernel(
            lambda: [run_sweep(one, device=dev) for _ in range(reps)]
        ).items()}
        item_s = float(item.times[(f"synthetic[n_users="
                                   f"{SWEEP_FULL_USERS}]", "egp")][0, 0])
        b1 = sum(v for k, v in by_kernel.items() if "qos_matrix" in k)
        b3 = sum(v for k, v in by_kernel.items() if "greedy_argmax" in k)
        busy = sum(by_kernel.values())
        log(f"  full width (U={SWEEP_FULL_USERS}): {full_s:.2f} s for "
            f"{2 * SWEEP_FULL_SEEDS} items in one-item chunks, host path "
            f"{host_s:.2f} s; accel vs host max diff {diff:.3g}; items/s "
            f"by executor {rates}; span totals (s) {spans['totals']}")
        log(f"  one item: launches {one_launches} (B3 = greedy "
            f"iterations), {1e3 * item_s:.1f} ms; device busy "
            f"{busy:.2f} ms (idle {100 * (1 - busy / (1e3 * item_s)):.1f} "
            f"%; B1 {b1:.4f}, B3 {b3:.3f}); top kernels "
            f"{sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]}")
        out["full"] = dict(s=full_s, host_s=host_s, diff=diff, rates=rates,
                           one_launches=one_launches, item_ms=1e3 * item_s,
                           busy_ms=busy, b1_ms=b1, b3_ms=b3, **spans)

        # --- 3. every registered scenario at its own configuration --------
        names = tuple(list_scenarios())
        check(names == SWEEP_SCENARIOS, f"scenario registry {names}")
        scen = SweepSpec(scenarios=names, algos=accel,
                         seeds=range(SWEEP_SCENARIO_SEEDS))
        tracer = obs.enable()
        t0 = time.perf_counter()
        res = run_sweep(scen, store / "scenarios", device=dev)
        torch.cuda.synchronize()
        scen_s = time.perf_counter() - t0
        n_items = len(scen.expand())
        diff = _sweep_check(scen, res, _host_columns(scen), "scenarios")
        log(f"  every scenario ({n_items} items): {scen_s:.2f} s, accel "
            f"vs host max diff {diff:.3g}; span totals (s) "
            f"{_span_totals(tracer)['totals']}")
        log("  table:\n" + table(res))
        pairs = [(s, t) for s in range(SWEEP_SCENARIO_SEEDS)
                 for t in range(8)]
        insts = materialize("edge_failure", (), pairs)
        _, xs = evaluate_batch(bucket_instances(insts, device=dev), "egp")
        for (seed, tick), inst, x in zip(pairs, insts, xs):
            for when, edge in ((3, 1), (5, 4)):
                if tick >= when:
                    check(inst.R[edge] == 0.0
                          and not bool(x[edge].any()),
                          f"edge_failure seed {seed} tick {tick}: dead "
                          f"edge {edge} places something")
        log("  edge_failure: dead edges 1 (tick 3 on) and 4 (tick 5 on) "
            "place nothing")
        out["scenarios"] = dict(s=scen_s, items=n_items, diff=diff)

        # --- 4. resume and chunking ---------------------------------------
        rows = dataclasses.replace(scen, scenarios=("flash_crowd",
                                                    "edge_failure"))
        d = store / "resume"
        part = run_sweep(rows, d, device=dev, chunk_size=1, max_chunks=2)
        check(part.execution["chunks_computed"] == 2 and not part.complete,
              f"killed run {part.execution}")
        done = run_sweep(rows, d, device=dev)
        again = run_sweep(rows, d, device=dev)
        n_rows = len(rows.expand())
        check(done.execution["items_skipped"] == 2
              and again.execution["chunks_computed"] == 0
              and again.execution["items_skipped"] == n_rows,
              f"resume: {done.execution}, {again.execution}")
        one_shot = run_sweep(rows, store / "one_shot", device=dev)
        flat = run_sweep(rows, store / "flat", device=dev, bucketed=False)
        obs.disable()
        untraced = run_sweep(rows, store / "untraced", device=dev)
        for other, what in ((again, "the resumed store's reload"),
                            (one_shot, "a one-shot run"),
                            (flat, "a globally padded run"),
                            (untraced, "a run with tracing off")):
            check(_same_values(done, other),
                  f"resume: values differ from {what}")
        for variant_algo, vals in done.values.items():
            check(vals.tobytes() ==
                  res.values[variant_algo].tobytes(),
                  f"resume: {variant_algo} differs from part 3")
        log(f"  flash_crowd + edge_failure ({n_rows} items): killed after "
            "2 one-item chunks, resumed, a third call computed nothing; "
            "bit-identical to a one-shot run, a globally padded run, a run "
            "with tracing off and part 3")
    torch.cuda.empty_cache()
    return out


# ===========================================================================
# phase 14: the serving tick
# ===========================================================================

def result_digest(result) -> str:
    """SHA-256 over a horizon result, the reference's
    ``repro/gateway/control.py::result_digest`` byte for byte: every
    request's (uid, impl, arrival, finish) and every TickReport field."""
    import dataclasses
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    reqs = result.requests
    h.update(np.array([r.uid for r in reqs], np.int64).tobytes())
    h.update(np.array([r.impl for r in reqs], np.int64).tobytes())
    h.update(np.array([r.arrival for r in reqs], np.float64).tobytes())
    h.update(np.array([r.finish for r in reqs], np.float64).tobytes())
    for rep in result.per_tick:
        h.update(repr(dataclasses.astuple(rep)).encode())
    return h.hexdigest()


def _sigma_bound_sparse(inst, cand_idx, cand_q, dev) -> float:
    """σ̄ of ``sigma_upper_bound_np`` over the candidate pairs, in float64:
    each user's best candidate that fits its edge's whole budget. With
    every eligible implementation kept (k = M) the pairs hold every
    nonzero of the dense Q, whose [10^6, 537] float64 copy the host
    version would build."""
    import torch

    from repro_torch.core import FEASIBILITY_TOL

    sm_r = torch.from_numpy(inst.sm_r.astype("float64")).to(dev)
    R = torch.from_numpy(inst.R.astype("float64")).to(dev)
    u_edge = torch.from_numpy(inst.u_edge).to(dev).long()
    valid = cand_idx >= 0
    fits = valid & (sm_r[cand_idx.clamp_min(0).long()]
                    <= (R[u_edge] + FEASIBILITY_TOL)[:, None])
    q = torch.where(fits, cand_q.to(torch.float64), 0.0)
    return float(q.amax(dim=1).sum())


def phase_serving_tick(dev, inst, main_path, keep_store=None) -> dict:
    """The traced 10^6-user tick (B2 once, B3 once an iteration), the
    serving horizons of every scenario and policy, and a serving sweep
    killed and resumed (its store copied to ``keep_store`` if given)."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import (TorchInstance, egp_place_sparse_torch,
                                  impl_table_np, sigma_sparse_torch)
    from repro_torch.kernels.qos_matrix import ops
    from repro_torch.serving.horizon import HorizonConfig, run_horizon
    from repro_torch.sweeps import SERVING_METRIC_NAMES, SweepSpec, run_sweep
    from repro_torch.sweeps.store import SweepStore
    from repro_torch.workloads import list_scenarios

    out = {}
    # --- 1. the traced main-path tick, counted ----------------------------
    ti = TorchInstance.from_pies(inst, dev)
    table = torch.from_numpy(
        impl_table_np(inst.sm_service, inst.S).astype(np.int32)).to(dev)

    def loop(ci, cq, traced):
        return egp_place_sparse_torch(ci, cq, ti.u_edge, ti.sm_service,
                                      ti.sm_r, ti.R, max_iters=inst.P + 1,
                                      with_trace=traced)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    cand_idx, cand_q = ops.qos_candidates_from_instance(ti, table)
    x, iters, trace = loop(cand_idx, cand_q, True)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"  traced tick launches {launches}, {iters} iterations")
    check(launches["qos_candidates"] == 1
          and launches["greedy_argmax"] == iters,
          f"traced tick launches {launches} for {iters} iterations")
    check(iters == main_path["iterations"]
          and launches["greedy_argmax"]
          == main_path["launches"]["greedy_argmax"],
          f"traced tick: {iters} iterations, phase 3 "
          f"{main_path['iterations']}")
    check(torch.equal(x.cpu(), main_path["x"]),
          "traced tick x differs from phase 3's untraced tick")
    # the loop alone, untraced and traced, one after the other
    walls = {False: [], True: []}
    for _ in range(2):
        for traced in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop(cand_idx, cand_q, traced)
            torch.cuda.synchronize()
            walls[traced].append(1e3 * (time.perf_counter() - t0))
    fields = [k for k in trace if k != "n_iters"]
    trace_bytes = sum(trace[k].numel() * trace[k].element_size()
                      for k in fields)
    sigma = float(sigma_sparse_torch(cand_idx, cand_q, ti.u_edge, x))
    bound = _sigma_bound_sparse(inst, cand_idx, cand_q, dev)
    led = obs.DecisionLedger()
    t0 = time.perf_counter()
    rec = obs.ingest_sparse_trace(led, trace, tick=0, seed=SEED,
                                  sigma=sigma, sigma_bound=bound)
    ingest_s = time.perf_counter() - t0
    n_pick = int((trace["pick"] >= 0).sum())
    n_x = int(x.sum())
    check(rec["n_picks"] == n_pick and rec["n_placed"] == n_x
          == int(trace["placed"].sum()),
          f"ledger picks {rec['n_picks']}/{n_pick}, placed "
          f"{rec['n_placed']}/{n_x}")
    gain_rel = abs(rec["gain_sum"] - sigma) / sigma
    check(gain_rel <= TRACE_GAIN_RTOL,
          f"ledger gain_sum {rec['gain_sum']!r} vs sigma {sigma!r}")
    check(0.0 < rec["ratio"] <= 1.0, f"certificate ratio {rec['ratio']}")
    log(f"  traced tick: x and iterations equal phase 3's, B3 launches "
        f"equal; loop untraced {walls[False]} ms, traced {walls[True]} ms; "
        f"trace {trace_bytes / 2**20:.2f} MiB on the card "
        f"([{inst.P + 1}, {inst.E}] x {len(fields)}); ingest "
        f"{ingest_s:.2f} s on the host for {rec['n_picks']} picks "
        f"({rec['n_placed']} placed); gain_sum {rec['gain_sum']!r} vs "
        f"sigma {sigma!r} (rel {gain_rel:.3g}); sigma bound {bound!r}, "
        f"ratio {rec['ratio']:.4f}, cert_ok {rec['cert_ok']}")
    out["trace"] = dict(launches=launches, iterations=iters,
                        untraced_ms=walls[False], traced_ms=walls[True],
                        trace_bytes=trace_bytes, ingest_s=ingest_s,
                        n_picks=rec["n_picks"], gain_rel=gain_rel,
                        ratio=rec["ratio"])
    del ti, cand_idx, cand_q, trace, x
    torch.cuda.empty_cache()

    # --- 2. the serving horizons of every scenario and policy -------------
    names = tuple(list_scenarios())
    check(names == SWEEP_SCENARIOS, f"scenario registry {names}")
    log(f"  numpy {np.__version__}; load {TICK_LOAD}, seeds "
        f"{list(TICK_SEEDS)}")
    spans, host_s, n_ticks, rows = {}, 0.0, 0, {}
    for sc in names:
        for pol in TICK_POLICIES:
            for seed in TICK_SEEDS:
                cfg = HorizonConfig(scenario=sc, policy=pol, seed=seed,
                                    **TICK_LOAD)
                t0 = time.perf_counter()
                res = run_horizon(cfg)
                host_s += time.perf_counter() - t0
                n_ticks += len(res.per_tick)
                what = f"horizon {sc}/{pol}/seed {seed}"
                check(res.served + res.dropped == res.submitted
                      and res.served == len(res.requests)
                      and all(t.served + t.dropped == t.submitted
                              for t in res.per_tick),
                      f"{what}: conservation")
                digest = result_digest(res)
                check(result_digest(run_horizon(cfg)) == digest,
                      f"{what}: a rerun differs")
                tracer = obs.enable()
                obs.enable_ledger()
                obs.enable_request_tracing()
                try:
                    on = run_horizon(cfg)
                finally:
                    obs.disable_request_tracing()
                    led = obs.disable_ledger()
                    obs.disable()
                check(result_digest(on) == digest,
                      f"{what}: differs with obs, ledger and reqtrace on")
                recs = led.records()
                check(len(recs) == len(res.per_tick) and all(
                    abs(r["gain_sum"] - r["sigma"]) <= 1e-6 for r in recs),
                      f"{what}: ledger records")
                for name, s in _span_totals(tracer)["totals"].items():
                    spans[name] = spans.get(name, 0.0) + s
                if seed == 0:
                    check(digest == TICK_DIGESTS[(sc, pol)],
                          f"{what}: digest {digest} is not the "
                          f"reference's {TICK_DIGESTS[(sc, pol)]}")
                rows.setdefault((sc, pol), []).append(
                    (res.mean_realized_qos, res.miss_rate))
    for (sc, pol), vals in rows.items():
        log(f"    {sc:20s} {pol:8s} realized QoS "
            f"{[round(q, 6) for q, _ in vals]}, miss rate "
            f"{[round(m, 6) for _, m in vals]}")
    tick_spans = {k: round(v, 4) for k, v in sorted(spans.items())
                  if k.startswith(("tick.", "horizon.", "kernel."))}
    log(f"  {len(rows) * len(TICK_SEEDS)} horizons, {n_ticks} ticks: "
        f"{host_s:.3f} s untraced on the host ({1e3 * host_s / n_ticks:.3f} "
        f"ms a tick); conservation holds, reruns and runs with obs, ledger "
        f"and reqtrace on are byte-identical, seed 0's digests are the "
        f"reference's; traced span totals (s) {tick_spans}")
    out["horizons"] = dict(host_s=host_s, ticks=n_ticks, spans=tick_spans,
                           qos={f"{sc}/{pol}": v
                                for (sc, pol), v in rows.items()})

    # --- 3. a kind="serving" sweep, killed and resumed --------------------
    spec = SweepSpec(kind="serving", scenarios=TICK_SWEEP_SCENARIOS,
                     algos=TICK_POLICIES, seeds=range(TICK_SWEEP_SEEDS),
                     override_grid=(TICK_LOAD,))
    items = spec.expand()
    first = items[0]
    n_first = sum((it.scenario, it.algo, it.seed)
                  == (first.scenario, first.algo, first.seed)
                  for it in items)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        d = Path(tmp) / "serving"
        t0 = time.perf_counter()
        part = run_sweep(spec, d, max_chunks=1)
        check(part.execution["chunks_computed"] == 1 and not part.complete,
              f"killed serving sweep {part.execution}")
        done = run_sweep(spec, d)
        again = run_sweep(spec, d)
        sweep_s = time.perf_counter() - t0
        check(done.execution["items_skipped"] == n_first
              and done.execution["path"] == "serving"
              and again.execution["chunks_computed"] == 0
              and again.execution["items_skipped"] == len(items),
              f"serving resume: {done.execution}, {again.execution}")
        one_shot = run_sweep(spec, Path(tmp) / "one_shot")
        for other, what in ((again, "the resumed store's reload"),
                            (one_shot, "a one-shot run")):
            check(_same_values(done, other),
                  f"serving sweep: values differ from {what}")
        store = SweepStore(d)
        check(all(set(store.metrics(k)) == set(SERVING_METRIC_NAMES)
                  for k in store.keys()), "serving sweep: item metrics")
        if keep_store is not None:
            shutil.copytree(d, keep_store)
    log(f"  serving sweep ({len(items)} items, {spec.store_key()}): "
        f"killed after one chunk, resumed, a third call computed nothing; "
        f"bit-identical to a one-shot run ({sweep_s:.2f} s)")
    out["sweep"] = dict(items=len(items), s=sweep_s)
    return out


# ===========================================================================
# phase 6: attention kernels vs plain versions
# ===========================================================================

def _randn(shape, dtype, gen):
    import torch

    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def _sdpa(q, k, v, **kw):
    """torch's scaled_dot_product_attention on [B, S, H, hd] tensors."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True, **kw)


def _held_in_ulps(out, ref, what: str) -> str:
    """For bf16 outputs, check the ulp bound and return its reading for
    the log line; nothing for float32."""
    import torch

    if out.dtype != torch.bfloat16:
        return ""
    _, ulps = bf16_ulp_err(out, ref)
    check(ulps <= BF16_ULPS, f"{what} bf16 beyond {BF16_ULPS} ulps + "
          f"{BF16_ATOL} ({ulps:.3g} ulps)")
    return f" ({ulps:.3g} ulps beyond {BF16_ATOL})"


def _rates(n_ops: float, ms: float, bound: float, lib: float,
           lib_name: str = "sdpa") -> str:
    """A kernel's achieved TFLOP/s (the algorithm's operations over its
    time) and its time as a multiple of its bound and of a library call's."""
    return (f"{n_ops / ms / 1e9:.1f} TFLOP/s, {ms / bound:.2f}x its bound, "
            f"{ms / lib:.2f}x {lib_name}")


def phase_attention_kernels(dev) -> dict:
    """B4 and B7 against their plain versions; numbers at the serving
    path's shapes (bfloat16)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gqa_decode as gd

    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    # --- B4 flash attention (prefill) ----------------------------------
    # (label, B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap)
    main = ("serving", SERVE_B, SERVE_PROMPT, SERVE_PROMPT, 15, 5, 64, True,
            0, 0.0)
    cases = [main,
             ("gemma2 width", 1, 4500, 4500, 4, 2, 128, True, 4096, 50.0),
             ("gemma2 width, global", 1, 4500, 4500, 4, 2, 128, True, 0,
              50.0),
             ("non-causal ragged", 2, 200, 333, 8, 2, 32, False, 0, 0.0),
             ("zamba2 width", SERVE_B, SERVE_PROMPT, SERVE_PROMPT, 32, 32,
              80, True, 0, 0.0)] + [
             (label, 2, SERVE_PROMPT, SERVE_PROMPT, Hq, Hkv, hd, True, 0,
              0.0) for label, _, _, Hq, Hkv, hd in MOE_ATTN_SHAPES] + [
             ("smoke hd=16, window", 4, 16, 16, 4, 2, 16, True, 16, 0.0),
             ("smoke hd=16, G=8", 4, 16, 16, 8, 1, 16, True, 0, 0.0),
             ("hd=16 non-causal ragged", 2, 100, 100, 4, 4, 16, False, 0,
              30.0)]
    err = 0.0
    for dtype in ("float32", "bfloat16"):
        for label, B, Sq, Skv, Hq, Hkv, hd, causal, window, cap in cases:
            dt = getattr(torch, dtype)
            q = _randn((B, Sq, Hq, hd), dt, gen)
            k = _randn((B, Skv, Hkv, hd), dt, gen)
            v = _randn((B, Skv, Hkv, hd), dt, gen)
            kw = dict(causal=causal, window=window, softcap=cap)
            o, lse = fa.flash_attention_cuda(q, k, v, **kw)
            ro, rlse = fa.attention_ref(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            e_o = float((o.float() - ro.float()).abs().max())
            e_l = float((lse - rlse).abs().max())
            ulps = _held_in_ulps(o, ro, f"flash_attention {label}")
            log(f"  flash_attention {label} {dtype} [{B},{Sq},{Skv},{Hq}/"
                f"{Hkv},{hd}] causal={causal} window={window} softcap={cap}:"
                f" max_abs_err out {e_o:.3g}{ulps}, lse {e_l:.3g}")
            check(max(e_o, e_l) <= ATTN_TOL[dtype],
                  f"flash_attention {label} {dtype} err {e_o}, {e_l}")
            err = max(err, e_o, e_l)
            del o, lse, ro, rlse
    _, B, Sq, Skv, Hq, Hkv, hd, causal, window, cap = main
    dt = torch.bfloat16
    q = _randn((B, Sq, Hq, hd), dt, gen)
    k = _randn((B, Skv, Hkv, hd), dt, gen)
    v = _randn((B, Skv, Hkv, hd), dt, gen)
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    plain = time_ms(lambda: fa.attention_ref(q, k, v, causal=True,
                                             return_lse=True))
    lib = time_ms(lambda: _sdpa(q, k, v, is_causal=True))
    n_ops, n_bytes = fa.flash_attention_cost(B, Sq, Skv, Hq, Hkv, hd, 2,
                                             causal, window)
    b, by = bound_ms(n_bytes, n_ops, BF16_OPS_S)
    out["flash_attention"] = dict(
        shape=[B, Sq, Hq, Hkv, hd], max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=b, bound_by=by, library_ms=lib, ops=n_ops,
        note="bf16: tensor-core products (mma.sync), P split into two bf16 "
             "terms; float32: CUDA-core products")
    del q, k, v
    # the shapes the MoE family's and the cluster's prefills give it
    shapes = []
    for label, B, S, Hq, Hkv, hd in MOE_ATTN_SHAPES + SMOKE_ATTN_SHAPES:
        q = _randn((B, S, Hq, hd), dt, gen)
        k = _randn((B, S, Hkv, hd), dt, gen)
        v = _randn((B, S, Hkv, hd), dt, gen)
        n_ops, n_bytes = fa.flash_attention_cost(B, S, S, Hq, Hkv, hd, 2)
        b, by = bound_ms(n_bytes, n_ops, BF16_OPS_S)
        shapes.append(dict(
            label=label, shape=[B, S, Hq, Hkv, hd],
            ms=time_ms(lambda: fa.flash_attention_cuda(q, k, v)),
            plain_ms=time_ms(lambda: fa.attention_ref(q, k, v,
                                                      return_lse=True)),
            library_ms=time_ms(lambda: _sdpa(q, k, v, is_causal=True)),
            bound_ms=b, bound_by=by))
        log(f"  flash_attention {label} {shapes[-1]}")
        del q, k, v
    out["flash_attention"]["shapes"] = shapes

    # --- B7 GQA decode ----------------------------------------------------
    # (label, B, Sc, Hkv, G, hd, kv_len, window, ring, softcap); besides the
    # serving shapes, the split plan's edges: rows of 1, 7, 64 and 65 slots
    # over 8 splits (empty and one-slot splits), a window narrower than 8
    # splits x 64 slots, ring past an Sc that is no multiple of 64, kv_len
    # 0 with G = 8 (two chunks of 4 heads), G = 5 at hd = 80
    main_len = (1, 7, 64, 129, 1000, 1024, 2047, 2048)[:SERVE_B]
    cases = [("serving", SERVE_B, SERVE_SEQ, 5, 3, 64, main_len, 0, False,
              0.0),
             ("ring Sc=40", 2, 40, 2, 2, 32, (50, 30), 0, True, 0.0),
             ("gemma2 width", 2, 4500, 2, 2, 128, (4500, 300), 4096, False,
              50.0),
             ("past Sc", 2, 48, 5, 3, 32, (200, 7), 0, False, 0.0),
             ("zamba2 width", SERVE_B, SERVE_SEQ, 32, 1, 80, main_len, 0,
              False, 0.0),
             ("short rows", 4, SERVE_SEQ, 5, 3, 64, (1, 7, 64, 65), 0, False,
              0.0),
             ("window 40 < splits x 64", 2, 1024, 2, 3, 64, (1000, 600), 40,
              False, 0.0),
             ("ring past Sc=300", 2, 300, 2, 3, 32, (1000, 299), 0, True,
              0.0),
             ("Sc=100, G=8", 3, 100, 1, 8, 128, (100, 37, 0), 0, False, 30.0),
             ("G=5 hd=80", 2, SERVE_SEQ, 2, 5, 80, (1040, 65), 0, False,
              0.0)] + [
             (label, SERVE_B, SERVE_SEQ, Hkv, Hq // Hkv, hd, main_len, 0,
              False, 0.0) for label, _, _, Hq, Hkv, hd in MOE_ATTN_SHAPES] + [
             ("smoke hd=16", 4, 64, 2, 2, 16, (17, 18, 19, 20), 0, False,
              0.0),
             ("smoke hd=16 ring", 4, 16, 2, 2, 16, (17, 18, 19, 20), 16,
              True, 0.0),
             ("smoke hd=16, G=8", 4, 64, 1, 8, 16, (20, 1, 64, 0), 0, False,
              30.0)]
    err = 0.0
    for dtype in ("float32", "bfloat16"):
        for label, B, Sc, Hkv, G, hd, lens, window, ring, cap in cases:
            dt = getattr(torch, dtype)
            q = _randn((B, Hkv * G, hd), dt, gen)
            kc = _randn((B, Sc, Hkv, hd), dt, gen)
            vc = _randn((B, Sc, Hkv, hd), dt, gen)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            kw = dict(window=window, ring=ring, softcap=cap)
            o = gd.gqa_decode_cuda(q, kc, vc, kv_len, **kw)
            ro = gd.gqa_decode_ref(q, kc, vc, kv_len, **kw)
            torch.cuda.synchronize()
            e = float((o.float() - ro.float()).abs().max())
            ulps = _held_in_ulps(o, ro, f"gqa_decode {label}")
            log(f"  gqa_decode {label} {dtype} [{B},{Sc},{Hkv}x{G},{hd}] "
                f"kv_len={list(lens)} window={window} ring={ring} "
                f"softcap={cap} splits="
                f"{gd.decode_splits(B, Hkv, Sc, _sm_count())}: max_abs_err "
                f"{e:.3g}{ulps}")
            check(e <= ATTN_TOL[dtype], f"gqa_decode {label} {dtype} err {e}")
            check(torch.equal(o, gd.gqa_decode_cuda(q, kc, vc, kv_len, **kw)),
                  f"gqa_decode {label} {dtype}: two calls differ")
            err = max(err, e)
    # timed where the serving paths decode: 8 rows at position 1040, at
    # smollm's and zamba2's shapes (bf16); events, and the kernel's device
    # time alone (torch.profiler), beside SDPA's
    timed = {}
    decode_shapes = [(label, SERVE_B, SERVE_SEQ, Hkv, G, hd)
                     for label, Hkv, G, hd in (("smollm", 5, 3, 64),
                                               ("zamba2", 32, 1, 80))] + [
        (label, B, SERVE_SEQ if S > 16 else 64, Hkv, Hq // Hkv, hd)
        for label, B, S, Hq, Hkv, hd in MOE_ATTN_SHAPES + SMOKE_ATTN_SHAPES]
    for label, B, Sc, Hkv, G, hd in decode_shapes:
        dt = torch.bfloat16
        lens = [SERVE_PROMPT + SERVE_STEPS // 2 if Sc > 64 else 18] * B
        q = _randn((B, Hkv * G, hd), dt, gen)
        kc = _randn((B, Sc, Hkv, hd), dt, gen)
        vc = _randn((B, Sc, Hkv, hd), dt, gen)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        idx = torch.arange(Sc, device=dev)
        mask = (idx[None, :] < kv_len[:, None])[:, None, None, :]

        def kernel():
            return gd.gqa_decode_cuda(q, kc, vc, kv_len)

        def sdpa():
            return _sdpa(q[:, None], kc, vc, attn_mask=mask)

        slots = gd.decode_slots(lens, Sc)      # valid cache slots read
        n_ops, n_bytes = gd.gqa_decode_cost(B, Hkv, G, hd, 2, slots)
        b, by = bound_ms(n_bytes, n_ops, BF16_OPS_S)
        timed[label] = dict(
            shape=[B, Sc, Hkv, G, hd], ms=time_ms(kernel),
            device_ms=device_ms_per_call(kernel, "gqa_decode_kernel"),
            plain_ms=time_ms(lambda: gd.gqa_decode_ref(q, kc, vc, kv_len)),
            library_ms=time_ms(sdpa), library_device_ms=device_ms_total(sdpa),
            bound_ms=b, bound_by=by, ops=n_ops,
            splits=gd.decode_splits(B, Hkv, Sc, _sm_count()))
        r = timed[label]
        log(f"  gqa_decode {label} {r['shape']} bf16 kv_len {lens[0]}, "
            f"{r['splits']} splits: kernel {r['ms']:.4f} ms events, "
            f"{r['device_ms']} ms device; plain {r['plain_ms']:.4f} ms; "
            f"sdpa {r['library_ms']:.4f} ms events, "
            f"{r['library_device_ms']} ms device; bound {b:.4f} ms ({by})")
        del q, kc, vc
    main, z = timed["smollm"], timed["zamba2"]
    out["gqa_decode"] = dict(
        main, max_abs_err=err,
        note=f"{main['splits']} splits a cluster; zamba2 {z['shape']}: "
             f"{z['ms']:.4f} ms events, {z['device_ms']} ms device, bound "
             f"{z['bound_ms']:.4f}, sdpa {z['library_ms']:.4f} ms events, "
             f"{z['library_device_ms']} ms device",
        shapes=[dict(label=label, **{k: v for k, v in r.items()
                                     if k != "ops"})
                for label, r in timed.items()
                if label not in ("smollm", "zamba2")])
    for name, r in out.items():
        log(f"  {name} {r['shape']} bf16: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), sdpa {r['library_ms']:.4f} ms; "
            f"{_rates(r['ops'], r['ms'], r['bound_ms'], r['library_ms'])}")
    torch.cuda.empty_cache()
    return out


# ===========================================================================
# phase 8: the SSD scan kernel vs its plain versions
# ===========================================================================

def _ssd_inputs(B, L, H, P, N, gen):
    """x, dtA, b, c drawn as tests/test_kernels.py draws them: normal x,
    b, c and dtA = -U(0.01, 0.4)."""
    import torch

    dev = gen.device
    x = torch.randn((B, L, H, P), generator=gen, device=dev)
    dtA = -(0.01 + 0.39 * torch.rand((B, L, H), generator=gen, device=dev))
    b = torch.randn((B, L, N), generator=gen, device=dev)
    c = torch.randn((B, L, N), generator=gen, device=dev)
    return x, dtA, b, c


def _ssd_err(out, ref) -> float:
    """Scale-free error of an SSD scan's ``(y, state)`` against a plain
    version's: the larger over the two of ``max |k - p| / max |p|``."""
    return max(float((k - p).abs().max() / p.abs().max().clamp_min(1e-30))
               for k, p in zip(out, ref))


def _ssd_work(B, L, H, P, N, chunk, with_init
              ) -> tuple[float, float, str]:
    """``(bytes, operations, algorithm)`` one scan needs: the bytes and the
    cheaper of the two algorithms' operations of
    ``ssd_scan.ops.ssd_scan_work``."""
    from repro_torch.kernels.ssd_scan import ops as ss_ops

    n_bytes, ops = ss_ops.ssd_scan_work(B, L, H, P, N, chunk, with_init)
    algo = min(ops, key=ops.get)
    return n_bytes, ops[algo], algo


def _ssd_plan_work(B, L, H, P, N, chunk, with_init
                   ) -> tuple[float, float]:
    """``(bytes, operations)`` of the work B8's four launches run: bf16
    tensor-core operations, 2 per multiply-add of every product over its
    64-row tiles (C·Bᵀ on and below the diagonal once per row and chunk;
    per head the chunk states, the scores times x and C times the entering
    state), times the 3 products of the hi/lo split; and the bytes moved,
    the scratch counted (x read twice, b and c twice, dtA twice, y and the
    final state written, C·Bᵀ, the chunk states and the entering states
    written once and read once, the initial state read)."""
    nc, n_sub = L // chunk, -(-chunk // 64)
    qp = 64 * n_sub
    tiles = n_sub * (n_sub + 1) // 2
    with_prev = nc - (0 if with_init else 1)
    macs = B * nc * (tiles * 64 * 64 * N
                     + H * (qp * P * N + tiles * 64 * 64 * P)) \
        + B * with_prev * H * qp * N * P
    n_bytes = 4 * (2 * B * L * H * P + 2 * 2 * B * L * N + 2 * B * L * H
                   + B * L * H * P + (2 if with_init else 1) * B * H * P * N
                   + 2 * B * nc * qp * qp + 2 * 2 * B * nc * H * P * N
                   + 2 * B * nc * H)
    return n_bytes, 3 * 2 * macs


def phase_ssd_kernel(dev) -> dict:
    """B8 against ssd_scan_ref and ssd_chunked; numbers at the mamba2
    serving shape."""
    import torch

    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device=dev).manual_seed(SEED)
    # (label, B, L, H, P, N, chunk, initial state)
    cases = [("mamba2 serving", SERVE_B, SERVE_PROMPT, 80, 64, 128, 256,
              False),
             ("zamba2 serving", SERVE_B, SERVE_PROMPT, 80, 64, 64, 256,
              False),
             ("ragged, initial state", 1, 300, 1, 64, 128, 256, True),
             # the smoke configs' P = N = 16 (chunk 8) at the edge
             # cluster's bucket: 4 rows, 16-token prompts, 8 heads
             ("smoke P=N=16", 4, 16, 8, 16, 16, 8, False),
             ("smoke P=N=16, initial state", 4, 16, 8, 16, 16, 8, True),
             ("P=N=16, 5 chunks", 2, 40, 8, 16, 16, 8, True),
             ("P=N=16 ragged", 1, 300, 3, 16, 16, 64, False)]
    rows, err = {}, 0.0
    for label, B, L, H, P, N, chunk, with_init in cases:
        x, dtA, b, c = _ssd_inputs(B, L, H, P, N, gen)
        s0 = torch.randn((B, H, P, N), generator=gen, device=dev) \
            if with_init else None
        kern = ss.ssd(x, dtA, b, c, chunk=chunk, initial_state=s0,
                      use_kernel=True)
        plain = {"ssd_scan_ref": ss.ssd_scan_ref(x, dtA, b, c,
                                                 initial_state=s0),
                 "ssd_chunked": ss.ssd(x, dtA, b, c, chunk=chunk,
                                       initial_state=s0, use_kernel=False)}
        torch.cuda.synchronize()
        check(bool(torch.isfinite(kern[0]).all() and
                   torch.isfinite(kern[1]).all()), f"ssd {label} finite")
        parts = []
        for name, ref in plain.items():
            e = _ssd_err(kern, ref)
            a = max(float((k - p).abs().max()) for k, p in zip(kern, ref))
            parts.append(f"vs {name} {e:.3g} (max abs {a:.3g}, max|y| "
                         f"{float(ref[0].abs().max()):.4g}, max|state| "
                         f"{float(ref[1].abs().max()):.4g})")
            check(e <= SSD_TOL, f"ssd_scan {label} vs {name}: {e}")
            err = max(err, a)
        log(f"  ssd_scan {label} [{B},{L},{H},{P},{N}] chunk {chunk}: "
            "scale-free error " + "; ".join(parts))
        del kern, plain
        if L % chunk:
            continue
        # each launch's scratch against ssd_chunked's intermediates, and
        # two calls bit for bit (no atomics)
        got = ss.ssd_scan_cuda_steps(x, dtA, b, c, chunk=chunk,
                                     initial_state=s0)
        want = ss.ssd_chunked_steps(x, dtA, b, c, chunk, initial_state=s0)
        low = torch.ones(chunk, chunk, dtype=torch.bool, device=dev).tril()
        steps = {"cb": _ssd_err(
            (got["cb"][:, :, :chunk, :chunk][:, :, low],),
            (want["cb"][:, :, low],))}
        steps.update({k: _ssd_err((got[k],), (want[k],)) for k in
                      ("chunk_states", "entering_states")})
        again = ss.ssd_scan_cuda(x, dtA, b, c, chunk=chunk, initial_state=s0)
        same = all(torch.equal(got[k], a) for k, a in
                   zip(("y", "final_state"), again))
        log("    launches' scratch vs ssd_chunked's intermediates, scale-"
            "free: " + ", ".join(f"{k} {e:.3g}" for k, e in steps.items())
            + f"; two calls bit-equal: {same}")
        check(all(e <= SSD_TOL for e in steps.values()),
              f"ssd_scan {label} intermediates {steps}")
        check(same, f"ssd_scan {label}: two calls differ")
        del got, want, again
        ms = time_ms(lambda: ss.ssd_scan_cuda(x, dtA, b, c, chunk=chunk,
                                              initial_state=s0))
        chunked = time_ms(lambda: ss.ssd_chunked(x, dtA, b, c, chunk, s0))
        seq = time_ms(lambda: ss.ssd_scan_ref(x, dtA, b, c, s0))
        n_bytes, n_ops, algo = _ssd_work(B, L, H, P, N, chunk, with_init)
        bnd, by = bound_ms(n_bytes, n_ops)
        log(f"    kernel {ms:.4f} ms, ssd_chunked {chunked:.4f} ms, "
            f"ssd_scan_ref {seq:.4f} ms, bound {bnd:.4f} ms ({by}: "
            f"{n_ops / 1e9:.4g} GFLOP {algo} at the float32 peak, "
            f"{n_bytes / 1e9:.4g} GB); kernel at {bnd / ms:.3g} of the "
            "float32 bound")
        rows[label] = dict(shape=[B, L, H, P, N], ms=ms, plain_ms=chunked,
                           sequential_ms=seq, bound_ms=bnd, bound_by=by,
                           library_ms=None)
        if P == 64:   # the tensor-core plan (P = 16 runs float32 loops)
            p_bytes, p_ops = _ssd_plan_work(B, L, H, P, N, chunk, with_init)
            p_bnd, p_by = bound_ms(p_bytes, p_ops, BF16_OPS_S)
            log(f"    the plan's bound {p_bnd:.4f} ms ({p_by}: "
                f"{p_ops / 1e9:.2f} GFLOP of bf16 products at the "
                f"tensor-core peak, {p_bytes / 1e9:.3f} GB with the "
                f"scratch); kernel at {p_bnd / ms:.3f} of the plan's")
            rows[label].update(plan_bound_ms=p_bnd, plan_bound_by=p_by)
        del x, dtA, b, c
    torch.cuda.empty_cache()
    z = rows["zamba2 serving"]
    note = (f"zamba2 shape {z['shape']}: {z['ms']:.4f} ms, bound "
            f"{z['bound_ms']:.4f} ({z['bound_by']}), plan bound "
            f"{z['plan_bound_ms']:.4f} ({z['plan_bound_by']}), "
            f"ssd_chunked {z['plain_ms']:.4f}")
    return {"ssd_scan": dict(
        rows["mamba2 serving"], max_abs_err=err, note=note,
        shapes=[dict(label=label, **r) for label, r in rows.items()
                if label.startswith("smoke")])}


# ===========================================================================
# phases 7, 9, 10: serving a model at full width
# ===========================================================================

def _teacher_forced(server, toks, new_tokens, use_kernel, cfg=None,
                    **front):
    """Prefill logits and every decode step's logits of ``server``'s model
    (under ``cfg``, by default the server's) fed the prompt (after the
    frontend's ``patches``, where ``front`` holds them) and then
    ``new_tokens`` (``[B, n]``)."""
    import torch

    from repro_torch.models import transformer as T

    cfg = cfg or server.cfg
    cache, ring = T.init_cache(cfg, toks.shape[0], server.bucket_seq,
                               toks.device)
    with torch.inference_mode():
        logits, cache = T.prefill(server.params, cfg, toks, cache, ring,
                                  use_kernel, **front)
        out = [logits[:, :cfg.vocab_size]]
        for t in range(new_tokens.shape[1]):
            logits, cache = T.decode_step(server.params, cfg,
                                          new_tokens[:, t], cache, ring,
                                          use_kernel)
            out.append(logits[:, :cfg.vocab_size])
    return torch.stack(out, dim=1)            # [B, n + 1, V]


class _Patched:
    """Within the block, each named function of the model layers
    (``models.layers``) is ``wrap(name, function)``; each wrapper sees the
    calls in layer order."""

    def __init__(self, wrap, names):
        from repro_torch.models import layers

        self.layers, self.wrap = layers, wrap
        self.saved = {n: getattr(layers, n) for n in names}

    def __enter__(self):
        for name, fn in self.saved.items():
            setattr(self.layers, name, self.wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.layers, name, fn)


def _held_against_plain(readings: dict):
    """Run the kernel and, on the same inputs, the plain version; append
    the reading of the kernel's output to ``readings[name]`` (an SSD scan:
    ``_ssd_err``; attention: ``bf16_ulp_err``); go on with the kernel's
    output."""
    def wrap(name, fn):
        def call(*args, use_kernel=None, **kw):
            out = fn(*args, use_kernel=True, **kw)
            ref = fn(*args, use_kernel=False, **kw)
            readings.setdefault(name, []).append(
                _ssd_err(out, ref) if name == "ssd"
                else bf16_ulp_err(out, ref))
            return out
        return call
    return wrap


def _drift(a, b) -> tuple[float, float]:
    """Max abs and root-mean-square difference of two logit tensors."""
    d = a.float() - b.float()
    return float(d.abs().max()), float(d.pow(2).mean().sqrt())


def _round_mantissa(x, bits: int):
    """``x`` rounded to ``bits`` mantissa bits (to nearest, ties away)."""
    import torch

    drop = 23 - bits
    i = x.float().view(torch.int32)
    i = (i + (1 << (drop - 1))) & -(1 << drop)
    return i.view(torch.float32).to(x.dtype)


def _layer0_rounded(n_layers: int, bits: int):
    """The wrapped functions (run as the caller asks: the plain versions
    in a plain run), with the output of every ``n_layers``-th call — layer
    0's, in a model that calls the function once per layer — rounded to
    ``bits`` mantissa bits (``y`` of a ``(y, state)`` pair): the control of
    the bf16 end-to-end limit."""
    calls = {}

    def wrap(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls[name] = calls.get(name, 0) + 1
            if (calls[name] - 1) % n_layers:
                return out
            if isinstance(out, tuple):
                return (_round_mantissa(out[0], bits),) + tuple(out[1:])
            return _round_mantissa(out, bits)
        return call
    return wrap


def _kernel_calls(cfg, steps: int) -> dict:
    """Calls of each kernel dispatcher in one generate (prefill + ``steps``
    decode steps): attention once per attention layer (dense, moe, audio,
    vlm) or shared-block application (hybrid), the SSD scan once per Mamba
    layer in the prefill and never in a decode step."""
    n_attn = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.shared_attn_every,
                                                       1)
              }.get(cfg.family, cfg.n_layers)
    n_mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    return {"attention": n_attn, "decode_attention": n_attn * steps,
            "ssd": n_mamba}


def _moe_routing_gate(p, cfg, x) -> dict:
    """Layer 0's routing of one prefill's hidden state ``x`` (its MoE
    input) on the card against the CPU's on the same state: the top-k
    experts equal except at near ties (two of a token's top k + 1
    probabilities within MOE_TIE_GAP), and the dropped assignments equal
    (where a near tie moved an assignment, outside the experts it
    touches)."""
    import torch

    from repro_torch.models import layers as L

    xs = x.reshape(-1, x.shape[-1])
    cap = L.moe_capacity(xs.shape[0], cfg)
    card = L.moe_route(xs, p.router, cfg, cap)
    router = p.router.detach().cpu()
    host = L.moe_route(xs.cpu(), router, cfg, cap)
    probs = torch.softmax(xs.cpu().float() @ router.float(), dim=-1)
    top = probs.sort(dim=-1, descending=True).values[:, :cfg.top_k + 1]
    near = (top[:, :-1] - top[:, 1:]).min(dim=-1).values < MOE_TIE_GAP
    idx, kept = card.idx.cpu(), card.kept.cpu()
    differ = (idx != host.idx).any(dim=-1)
    check(bool((near | ~differ).all()),
          f"MoE layer 0: {int((differ & ~near).sum())} tokens route to "
          "other experts on the card than on the CPU away from a near tie")
    moved = torch.unique(torch.cat([idx[differ], host.idx[differ]]))
    same = ~torch.isin(host.idx, moved) & ~differ[:, None]
    check(torch.equal(kept[same], host.kept[same]),
          "MoE layer 0: the card drops other assignments than the CPU")
    r = dict(moe_tokens=xs.shape[0], moe_capacity=cap,
             moe_dropped=int((~host.kept).sum()),
             moe_dropped_card=int((~kept).sum()),
             moe_idx_differ=int(differ.sum()), moe_near_ties=int(near.sum()))
    log(f"  MoE layer 0 routing, card vs CPU on the same hidden state: "
        f"{r['moe_tokens']} tokens x top-{cfg.top_k} of {cfg.n_experts} "
        f"experts, capacity {cap}; tokens whose experts differ "
        f"{r['moe_idx_differ']} (near ties below {MOE_TIE_GAP}: "
        f"{r['moe_near_ties']}); dropped assignments {r['moe_dropped']} "
        f"(card {r['moe_dropped_card']})")
    return r


def _gate_logits(run, cfg, spec: dict, calls: dict, picks=None) -> dict:
    """The gates of a served model whose logits ``run(use_kernel, cfg)``
    gives: every kernel call of a kernel run held against its plain
    version on its own inputs (bf16 attention within BF16_ULPS, the SSD
    scan within SSD_TOL of its largest value), as many calls as ``calls``
    says; the kernel logits finite and, where ``picks`` is given, picking
    those tokens (all but the last step); an MoE model's layer-0 routing
    on the card against the CPU's; the bf16 logits within the model's max
    abs and rms limits (``spec``), which the controls (layer 0's
    ``spec["control"]`` output rounded to fewer mantissa bits) must
    exceed; and the float32 logits within F32_LOGITS_TOL."""
    import torch

    held, first_moe = {}, []
    held_wrap = _held_against_plain(held)

    def wrap(name, fn):
        if name != "moe_block":
            return held_wrap(name, fn)

        def call(p, c, x, *rest):
            if not first_moe:
                first_moe.append((p, c, x.clone()))
            return fn(p, c, x, *rest)
        return call

    names = KERNEL_DISPATCHERS + (("moe_block",) if cfg.n_experts else ())
    with _Patched(wrap, names):
        kern = run(True, cfg)
    plain = run(False, cfg)
    check(bool(torch.isfinite(kern).all()), "kernel logits are finite")
    if picks is not None:
        check(torch.equal(kern[:, :-1].argmax(-1), picks),
              "teacher-forced kernel logits pick the generated tokens")
    n_held = {n: len(r) for n, r in held.items()}
    check(n_held == {n: c for n, c in calls.items() if c},
          f"kernel calls held {n_held}, expected {calls}")
    out = dict(held=n_held)
    attn = held.get("attention", []) + held.get("decode_attention", [])
    if attn:
        call_err = max(r[0] for r in attn)
        call_ulps = max(r[1] for r in attn)
        log(f"  bf16, every attention call of the teacher-forced run "
            f"({len(attn)} calls) kernel vs plain on its inputs: max abs "
            f"{call_err:.3g}, max {call_ulps:.3g} ulps beyond {BF16_ATOL} "
            f"(prefill max abs "
            f"{max(r[0] for r in held['attention']):.3g})")
        check(call_ulps <= BF16_ULPS,
              f"serving attention calls beyond {BF16_ULPS} bf16 ulps + "
              f"{BF16_ATOL} ({call_ulps:.3g} ulps)")
        check(call_err <= ATTN_TOL["bfloat16"],
              f"serving attention calls kernel vs plain max abs {call_err}")
        out.update(call_err=call_err, call_ulps=call_ulps)
    if "ssd" in held:
        ssd_err = max(held["ssd"])
        log(f"  every SSD scan call of the teacher-forced run "
            f"({len(held['ssd'])} calls, float32 inputs) kernel vs plain "
            f"on its inputs: scale-free error max {ssd_err:.3g}, layer 0 "
            f"{held['ssd'][0]:.3g}")
        check(ssd_err <= SSD_TOL, f"serving ssd calls kernel vs plain "
              f"scale-free error {ssd_err}")
        out.update(ssd_call_err=ssd_err)
    if first_moe:
        out.update(_moe_routing_gate(*first_moe[0]))
        del first_moe[:]
    drift = _drift(kern, plain)
    del kern
    controls = {}
    every = spec.get("control_every", cfg.n_layers)
    for bits in CONTROL_SWEEP:
        with _Patched(_layer0_rounded(every, bits), spec["control"]):
            ctrl = run(False, cfg)
        controls[bits] = _drift(ctrl, plain)
        del ctrl
    tol = spec["bf16_tol"]
    rms_tol, rms_bits = spec["bf16_rms"]
    log(f"  bf16 logits, kernels vs plain: max abs "
        f"{drift[0]:.4g}, rms {drift[1]:.4g} (limits {tol} max abs and "
        f"{rms_tol} rms, which the controls b={CONTROL_BITS} and "
        f"b={rms_bits} must exceed; |logits| up to "
        f"{float(plain.abs().max()):.3g}, rms "
        f"{float(plain.float().pow(2).mean().sqrt()):.4g})")
    which = "layer 0's" if every == cfg.n_layers else "every layer's"
    log(f"  control, the plain model with {which} {spec['control'][0]} "
        "output rounded to b mantissa bits, vs plain: " + ", ".join(
            f"b={b} max abs {e[0]:.4g} rms {e[1]:.4g}"
            for b, e in controls.items()))
    check(drift[0] <= tol,
          f"bf16 serving logits kernels vs plain max abs {drift[0]}")
    check(controls[CONTROL_BITS][0] > tol,
          f"control b={CONTROL_BITS} max abs {controls[CONTROL_BITS][0]} "
          f"within the limit {tol}: it does not separate")
    check(drift[1] <= rms_tol,
          f"bf16 serving logits kernels vs plain rms {drift[1]}")
    check(controls[rms_bits][1] > rms_tol,
          f"control b={rms_bits} rms {controls[rms_bits][1]} within the "
          f"limit {rms_tol}: it does not separate")
    out.update(bf16_logits_err=drift[0], bf16_logits_rms=drift[1],
               control_err=controls[CONTROL_BITS][0],
               control_rms=controls[rms_bits][1])
    del plain
    cfg32 = cfg.with_(dtype="float32")
    kern = run(True, cfg32)
    plain = run(False, cfg32)
    per_pos = (kern - plain).abs().amax(dim=(0, 2))
    err = float(per_pos.max())
    log(f"  float32 logits, kernels vs plain: max abs {err:.3g} (first "
        f"position {float(per_pos[0]):.3g}, worst {int(per_pos.argmax())}); "
        f"|logits| up to {float(kern.abs().max()):.3g}")
    check(err <= F32_LOGITS_TOL,
          f"float32 serving logits kernels vs plain max abs {err}")
    out.update(f32_logits_err=err)
    del kern, plain
    return out


def phase_serving(dev, arch: str, n_layers=None) -> dict:
    """One generate of ``arch`` at its published widths (its depth cut to
    ``n_layers`` where given), counted, then ``_gate_logits`` and the
    device time by kernel."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.serving import ModelServer

    full_depth = get_config(arch).n_layers
    cfg = get_config(arch, **({"n_layers": n_layers} if n_layers else {}))
    spec = SERVED[arch]
    t0 = time.perf_counter()
    server = ModelServer(cfg, bucket_batch=SERVE_B, bucket_seq=SERVE_SEQ,
                         seed=SEED, device=dev)
    n_params = sum(p.numel() for p in server.params.parameters())
    server.warmup()
    torch.cuda.synchronize()
    depth = (f"{cfg.n_layers} layers" if cfg.n_layers == full_depth else
             f"{cfg.n_layers} of its {full_depth} layers (depth cut: the "
             "full model does not fit one card)")
    moe = (f", {cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}, "
           f"capacity factor {cfg.capacity_factor}" if cfg.n_experts else "")
    log(f"  {cfg.name} ({cfg.family}): {depth}, d={cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd={cfg.head_dim}{moe}, "
        f"ssm {cfg.ssm_heads}x{cfg.ssm_head_dim} N={cfg.ssm_state}, vocab "
        f"{cfg.vocab_size}, {n_params} parameters ({cfg.param_dtype} "
        f"master, {cfg.dtype} compute); init + warmup "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT))

    # the main path: one generate, counted
    torch.cuda.synchronize()
    for mod in (fa, gd, ss):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    tokens, prefill_s, decode_s = server.generate(prompts, SERVE_STEPS)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = {**fa.LAUNCHES, **gd.LAUNCHES, **ss.LAUNCHES}
    calls = _kernel_calls(cfg, SERVE_STEPS)
    expect = {"flash_attention": calls["attention"],
              "flash_attention_dq": 0, "flash_attention_dkv": 0,
              "gqa_decode": calls["decode_attention"],
              "ssd_scan": calls["ssd"], "ssd_scan_bwd": 0}
    log(f"  generate launches: {launches} (expected {expect}); peak device "
        f"memory {peak_gb:.2f} GB")
    check(launches == expect, f"{arch} launches {launches} != {expect}")
    check(tokens.shape == (SERVE_B, SERVE_STEPS), "generated tokens shape")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "generated tokens in the vocabulary")
    new_tok_s = SERVE_B * SERVE_STEPS / decode_s
    log(f"  prefill {1e3 * prefill_s:.2f} ms ({SERVE_B}x{SERVE_PROMPT} "
        f"tokens), decode {1e3 * decode_s / SERVE_STEPS:.3f} ms/token-step "
        f"({SERVE_STEPS} steps), {new_tok_s:.1f} new tokens/s, "
        f"{SERVE_B * SERVE_STEPS / (prefill_s + decode_s):.1f} tokens/s "
        "end to end")

    # The same model with the plain versions, teacher-forced on those
    # tokens. In bf16 a kernel and its plain version compute the same
    # float32 values in different orders, so an output near a bf16
    # rounding boundary rounds to a neighbouring value, and the layers'
    # bf16 residual stream carries those ulps to the logits. So every
    # kernel call is held on its own inputs (attention at the ulp bound,
    # the SSD scan at SSD_TOL of its largest value), and the bf16 logits
    # at the model's limit, which the control must exceed.
    toks = torch.from_numpy(prompts).to(dev)
    new = torch.from_numpy(tokens.astype(np.int64)).to(dev)
    out = dict(prefill_ms=1e3 * prefill_s, new_tokens_per_s=new_tok_s,
               peak_gb=peak_gb, n_layers=cfg.n_layers,
               launches={k: launches[k] for k, n in expect.items() if n})
    out.update(_gate_logits(
        lambda use_kernel, c: _teacher_forced(server, toks, new, use_kernel,
                                              c),
        cfg, spec, calls, picks=new))

    # where the time goes: device time by kernel of the prefill and of four
    # decode steps after it, against generate's wall time per step
    from repro_torch.models import transformer as T

    cache, ring = T.init_cache(cfg, SERVE_B, SERVE_SEQ, dev)
    pre = device_ms_by_kernel(
        lambda: T.prefill(server.params, cfg, toks, cache, ring))
    n_prof = 4
    dec = device_ms_by_kernel(lambda: [
        T.decode_step(server.params, cfg, new[:, t], cache, ring)
        for t in range(n_prof)])
    step_busy = sum(dec.values()) / n_prof
    step_wall = 1e3 * decode_s / SERVE_STEPS
    step_b7 = sum(t for name, t in dec.items()
                  if "gqa_decode_kernel" in name) / n_prof
    log(f"  prefill device busy {sum(pre.values()):.2f} ms of "
        f"{1e3 * prefill_s:.2f} ms wall; decode step device busy "
        f"{step_busy:.3f} ms of {step_wall:.3f} ms wall (device idle "
        f"{100 * (1 - step_busy / step_wall):.1f} %), of which B7 "
        f"{step_b7:.3f} ms")
    for label, by_kernel in (("prefill", pre), (f"{n_prof} decode steps",
                                                 dec)):
        log(f"  {label}, device ms by kernel:")
        for name, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            log(f"    {t:9.3f} ms  {name[:90]}")
    del server, cache
    torch.cuda.empty_cache()
    out.update(decode_ms_per_step=step_wall, decode_busy_ms=step_busy,
               decode_b7_ms=step_b7)
    return out



# ===========================================================================
# phase 16: the audio and vision frontends at full width and depth
# ===========================================================================

def phase_frontends(dev) -> dict:
    """hubert-xlarge's forward of SERVE_B x SERVE_PROMPT audio frames
    (non-causal B4 at hd 80, G = 1, once per layer) and internvl2-1b's
    prefill of FRONTEND_PATCHES patch embeddings + FRONTEND_TOKENS tokens
    followed by SERVE_STEPS greedy decode steps (B4 once per layer, B7 once
    per layer per step), counted and timed, then ``_gate_logits``."""
    import types

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import transformer as T

    def counted(fn):
        torch.cuda.synchronize()
        for mod in (fa, gd, ss):
            mod.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, {
            **fa.LAUNCHES, **gd.LAUNCHES, **ss.LAUNCHES}

    def expected(cfg, steps):
        calls = _kernel_calls(cfg, steps)
        return calls, {"flash_attention": calls["attention"],
                       "flash_attention_dq": 0, "flash_attention_dkv": 0,
                       "gqa_decode": calls["decode_attention"],
                       "ssd_scan": 0, "ssd_scan_bwd": 0}

    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # --- hubert-xlarge: the encoder's forward over audio frames -------------
    cfg = get_config("hubert_xlarge")
    model = T.init_params(cfg, gen)
    frames = torch.randn((SERVE_B, SERVE_PROMPT, cfg.d_model),
                         generator=gen, device=dev)

    def encode(use_kernel, c):
        with torch.inference_mode():
            h = T.forward(model, c, None, use_kernel, frames=frames)
            return T.logits_fn(model, c, h)[..., :c.vocab_size]

    log(f"  {cfg.name} (audio, encoder-only, causal={cfg.causal}): "
        f"{cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, hd={cfg.head_dim}, head {cfg.vocab_size}; "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    encode(None, cfg)
    logits, wall, launches = counted(lambda: encode(None, cfg))
    calls, expect = expected(cfg, 0)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"  forward of {SERVE_B}x{SERVE_PROMPT} frames: {1e3 * wall:.2f} ms "
        f"wall, {SERVE_B * SERVE_PROMPT / wall:.0f} frames/s, peak "
        f"{peak:.2f} GB; launches {launches} (expected {expect})")
    check(launches == expect, f"hubert launches {launches} != {expect}")
    check(logits.shape == (SERVE_B, SERVE_PROMPT, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "hubert logits")
    out["hubert_xlarge"] = dict(forward_ms=1e3 * wall, peak_gb=peak,
                                launches={"flash_attention": cfg.n_layers})
    out["hubert_xlarge"].update(
        _gate_logits(encode, cfg, SERVED["hubert_xlarge"], calls))
    del model, frames, logits
    torch.cuda.empty_cache()

    # --- internvl2-1b: patches + tokens, then greedy decode -----------------
    cfg = get_config("internvl2_1b")
    model = T.init_params(cfg, gen)
    patches = torch.randn((SERVE_B, FRONTEND_PATCHES, cfg.d_model),
                          generator=gen, device=dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (SERVE_B, FRONTEND_TOKENS))).to(dev)
    V = cfg.vocab_size

    def generate(steps):
        with torch.inference_mode():
            cache, ring = T.init_cache(cfg, SERVE_B, SERVE_SEQ, dev)
            logits, cache = T.prefill(model, cfg, toks, cache, ring,
                                      patches=patches)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tok, new = logits[:, :V].argmax(-1), []
            for _ in range(steps):
                new.append(tok)
                logits, cache = T.decode_step(model, cfg, tok, cache, ring)
                tok = logits[:, :V].argmax(-1)
            torch.cuda.synchronize()
            return torch.stack(new, 1), time.perf_counter() - t1

    log(f"  {cfg.name} (vision): {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd={cfg.head_dim}, vocab "
        f"{cfg.vocab_size}; {sum(p.numel() for p in model.parameters())} "
        "parameters")
    generate(1)
    (new, decode_s), wall, launches = counted(lambda: generate(SERVE_STEPS))
    calls, expect = expected(cfg, SERVE_STEPS)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    prefill_s = wall - decode_s
    log(f"  prefill of {SERVE_B} x ({FRONTEND_PATCHES} patches + "
        f"{FRONTEND_TOKENS} tokens) {1e3 * prefill_s:.2f} ms, decode "
        f"{1e3 * decode_s / SERVE_STEPS:.3f} ms/step ({SERVE_STEPS} steps), "
        f"{SERVE_B * SERVE_STEPS / decode_s:.1f} new tokens/s, peak "
        f"{peak:.2f} GB; launches {launches} (expected {expect})")
    check(launches == expect, f"internvl2 launches {launches} != {expect}")
    check(bool(((new >= 0) & (new < V)).all()), "internvl2 tokens")
    out["internvl2_1b"] = dict(
        prefill_ms=1e3 * prefill_s, decode_ms_per_step=1e3 * decode_s
        / SERVE_STEPS, new_tokens_per_s=SERVE_B * SERVE_STEPS / decode_s,
        peak_gb=peak, launches={k: v for k, v in launches.items() if v})
    server = types.SimpleNamespace(params=model, cfg=cfg,
                                   bucket_seq=SERVE_SEQ)
    out["internvl2_1b"].update(_gate_logits(
        lambda use_kernel, c: _teacher_forced(server, toks, new, use_kernel,
                                              c, patches=patches),
        cfg, SERVED["internvl2_1b"], calls, picks=new))
    del model, patches, server
    torch.cuda.empty_cache()
    return out


# ===========================================================================
# phase 17: the edge cluster
# ===========================================================================

def phase_cluster(dev) -> dict:
    """``run_serving`` (the launcher's entry point) on the card at each
    CLUSTER_CASES point with edge CLUSTER_FAIL_EDGE failing: the
    decisions equal CLUSTER_EXPECTED (the expected QoS within QOS_TOL);
    B1 once per placement and routing; each generate of a resident
    (smoke-config) model launches B4, B7 and B8 as its family calls them;
    the realized QoS and each batch's wall time logged. Then the same runs
    with every B4/B7/B8 call held against its plain version on its own
    inputs."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import qos_matrix as qm
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch.serve import run_serving
    from repro_torch.serving import engine, router

    mods = (fa, gd, ss, qm)

    def counts():
        return {**fa.LAUNCHES, **gd.LAUNCHES, **ss.LAUNCHES, **qm.LAUNCHES}

    route, generate = router.Router.route, engine.ModelServer.generate
    out, total = {}, {}
    for case in CLUSTER_CASES:
        U, E, R = case
        routes, batches = [], []

        def routed(self, *args, **kw):
            routes.append(route(self, *args, **kw))
            return routes[-1]

        def timed(self, prompts, n_steps=8):
            before = counts()
            t0 = time.perf_counter()
            res = generate(self, prompts, n_steps)
            wall = time.perf_counter() - t0
            after = counts()
            batches.append((self.cfg, len(prompts), n_steps, wall,
                            {k: after[k] - before[k] for k in after}))
            return res

        router.Router.route, engine.ModelServer.generate = routed, timed
        try:
            torch.cuda.synchronize()
            for mod in mods:
                mod.reset_launch_counts()
            t0 = time.perf_counter()
            reports = run_serving(U, E, storage=R,
                                  fail_edge=CLUSTER_FAIL_EDGE, device=dev)
            wall = time.perf_counter() - t0
            launches = counts()
        finally:
            router.Router.route, engine.ModelServer.generate = route, generate
        check(len(routes) == 2, f"cluster {case}: {len(routes)} routings")
        for i, (rep, dec, want) in enumerate(zip(reports, routes,
                                                 CLUSTER_EXPECTED[case])):
            got = cluster_record(rep, dec.assignment)
            e_qos = abs(got["expected_qos"] - want["expected_qos"])
            log(f"  cluster {case} serve {i}: placed {got['placed']}, "
                f"served {rep.served} dropped {rep.dropped} skipped "
                f"{rep.skipped}, expected QoS {rep.mean_expected_qos:.6f} "
                f"({e_qos:.2g} from the reference), realized QoS "
                f"{rep.mean_realized_qos:.6f}, {rep.total_wall_s:.3f} s")
            check(e_qos <= QOS_TOL, f"cluster {case} serve {i} expected QoS "
                  f"{got['expected_qos']} vs {want['expected_qos']}")
            for key in ("placed", "assignment", "served", "dropped",
                        "skipped", "counts"):
                check(got[key] == want[key], f"cluster {case} serve {i} "
                      f"{key}: {got[key]} != {want[key]}")
        by_model = {}
        for cfg, b, steps, t, d in batches:
            calls = _kernel_calls(cfg, steps)
            want = {"flash_attention": calls["attention"],
                    "gqa_decode": calls["decode_attention"],
                    "ssd_scan": calls["ssd"]}
            got = {k: d[k] for k in want}
            check(got == want, f"cluster {case} {cfg.name} generate "
                  f"launches {got} != {want}")
            check(d["qos_matrix"] == 0 and d["flash_attention_dq"] == 0
                  and d["ssd_scan_bwd"] == 0,
                  f"cluster {case} {cfg.name}: other launches {d}")
            m = by_model.setdefault(cfg.name, dict(batches=0, requests=0,
                                                   ms=[], launches={}))
            m["batches"] += 1
            m["requests"] += b
            m["ms"].append(1e3 * t)
            for k, v in got.items():
                m["launches"][k] = m["launches"].get(k, 0) + v
        # B1 once per placement and routing: two serves and the failure's
        # re-placement
        check(launches["qos_matrix"] == 5,
              f"cluster {case}: {launches['qos_matrix']} B1 launches")
        batch_ms = [1e3 * t for *_, t, _ in batches]
        log(f"  cluster {case}: run_serving {wall:.3f} s wall; "
            f"{len(batches)} request batches, wall per batch median "
            f"{statistics.median(batch_ms):.2f} ms (min {min(batch_ms):.2f}, "
            f"max {max(batch_ms):.2f}); launches {launches}")
        for name, m in sorted(by_model.items()):
            log(f"    {name}: {m['batches']} batches, {m['requests']} "
                f"requests, ms per batch {statistics.median(m['ms']):.2f} "
                f"median, launches {m['launches']}")
        out[case] = dict(wall_s=wall, realized_qos=[
            r.mean_realized_qos for r in reports], batch_ms=batch_ms,
            by_model={n: dict(m, ms=statistics.median(m["ms"]))
                      for n, m in by_model.items()})
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

        # every kernel call of the same run held against its plain version
        held = {}
        with _Patched(_held_against_plain(held), KERNEL_DISPATCHERS):
            run_serving(U, E, storage=R, fail_edge=CLUSTER_FAIL_EDGE,
                        verbose=False, device=dev)
        n_held = {n: len(r) for n, r in held.items()}
        want_held = {"attention": launches["flash_attention"],
                     "decode_attention": launches["gqa_decode"],
                     "ssd": launches["ssd_scan"]}
        check(n_held == {k: v for k, v in want_held.items() if v},
              f"cluster {case}: calls held {n_held} != {want_held}")
        attn = held.get("attention", []) + held.get("decode_attention", [])
        ulps = max(r[1] for r in attn)
        ssd_err = max(held.get("ssd", [0.0]))
        log(f"  cluster {case}: every kernel call held against its plain "
            f"version on its inputs ({n_held}): attention max "
            f"{max(r[0] for r in attn):.3g} abs, {ulps:.3g} ulps beyond "
            f"{BF16_ATOL}; SSD scale-free {ssd_err:.3g}")
        check(ulps <= BF16_ULPS, f"cluster {case} attention calls {ulps} "
              "ulps")
        check(ssd_err <= SSD_TOL, f"cluster {case} ssd calls {ssd_err}")
        out[case].update(held=n_held, call_ulps=ulps, ssd_call_err=ssd_err)
    out["launches"] = total
    return out


# ===========================================================================
# phase 11: the flash-attention backward kernels vs their plain version
# ===========================================================================

def _bwd_err(out, ref) -> float:
    """Max abs difference over the plain output's largest |value|, or over
    1 where that is smaller."""
    return float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1.0))


def _bwd_work(B, Sq, Skv, Hq, Hkv, hd, causal, window, nbytes: int
              ) -> dict:
    """``{kernel: (bytes, operations)}`` of B5 and B6, from
    ``flash_attention.ops.flash_attention_bwd_cost``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return {name: (c.bytes, c.flops) for name, c in
            fa_ops.flash_attention_bwd_cost(B, Sq, Skv, Hq, Hkv, hd, nbytes,
                                            causal, window).items()}


@contextlib.contextmanager
def _cap_derivative_dropped():
    """Within the block, the plain backward (flash_attention_bwd_ref)
    leaves out the factor 1 - t^2 that the softcap's derivative puts on
    dS: the control of phase 11's softcap case."""
    from repro_torch.kernels.flash_attention import ref

    saved = ref._softcap
    ref._softcap = lambda s, c: (saved(s, c)[0], 1.0)
    try:
        yield
    finally:
        ref._softcap = saved


def _bwd_held_in(got, ref, dtype: str) -> list:
    """Each of dq, dk, dv held against ``ref`` at its dtype's gate:
    float32 within BWD_TOL of the largest value (or of 1), bf16 within
    BF16_ULPS; returns ``[(name, within, reading)]``."""
    out = []
    for n, a, b in zip(("dq", "dk", "dv"), got, ref):
        if dtype == "float32":
            e = _bwd_err(a, b)
            out.append((n, e <= BWD_TOL, e))
        else:
            e = bf16_ulp_err(a, b)[1]
            out.append((n, e <= BF16_ULPS, e))
    return out


def phase_backward_kernels(dev) -> dict:
    """B5 and B6 against flash_attention_bwd_ref (and, in float32, torch's
    autograd through attention_ref); numbers at the training shape
    (bfloat16), and at the training families' shapes (BWD_FAMILY_CASES):
    gemma2's softcap, with a control that drops the cap's derivative from
    the plain version, hd 16, G = 16 and G = 7."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED)
    # (label, B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap)
    main = ("training", TRAIN_B, TRAIN_S, TRAIN_S, 15, 5, 64, True, 0, 0.0)
    cases = [main,
             ("hd = 80, G = 1", 2, 512, 512, 8, 8, 80, True, 0, 0.0),
             ("window 256, hd = 128", 2, 1000, 1000, 6, 2, 128, True, 256,
              0.0),
             ("ragged Sq = 1000", 2, 1000, 1000, 15, 5, 64, True, 0, 0.0),
             ("non-causal, Sq != Skv", 2, 300, 333, 6, 2, 32, False, 0,
              0.0)] + BWD_FAMILY_CASES
    err = {"flash_attention_dq": 0.0, "flash_attention_dkv": 0.0}
    controls = {}
    for dtype in ("float32", "bfloat16"):
        for label, B, Sq, Skv, Hq, Hkv, hd, causal, window, cap in cases:
            dt = getattr(torch, dtype)
            q = _randn((B, Sq, Hq, hd), dt, gen)
            k = _randn((B, Skv, Hkv, hd), dt, gen)
            v = _randn((B, Skv, Hkv, hd), dt, gen)
            do = _randn((B, Sq, Hq, hd), dt, gen)
            kw = dict(causal=causal, window=window, softcap=cap)
            o, lse = fa.flash_attention_cuda(q, k, v, **kw)
            got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
            ref = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
            refs = {"plain": ref}
            if dtype == "float32":
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                out = fa.attention_ref(*leaves, **kw)
                refs["autograd"] = torch.autograd.grad(out, leaves, do)
                del leaves, out
            torch.cuda.synchronize()
            parts = []
            for name, r in refs.items():
                errs = [_bwd_err(a, b) for a, b in zip(got, r)]
                parts.append(f"vs {name}: " + ", ".join(
                    f"{n} {e:.3g}{_held_in_ulps(a, b, f'{label} {n}')}"
                    for n, e, a, b in zip(("dq", "dk", "dv"), errs, got, r)))
                if dtype == "float32":
                    check(max(errs) <= BWD_TOL,
                          f"backward {label} vs {name} err {errs}")
                err["flash_attention_dq"] = max(
                    err["flash_attention_dq"],
                    float((got[0].float() - r[0].float()).abs().max()))
                err["flash_attention_dkv"] = max(
                    err["flash_attention_dkv"], *(
                        float((a.float() - b.float()).abs().max())
                        for a, b in zip(got[1:], r[1:])))
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  f"backward {label} {dtype} finite")
            if cap:
                with _cap_derivative_dropped():
                    ctrl = fa.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                                      **kw)
                held = _bwd_held_in(got, ctrl, dtype)
                controls[dtype] = {n: e for n, _, e in held}
                parts.append("control (the plain version without the "
                             "cap's 1 - t^2): " + ", ".join(
                                 f"{n} {e:.3g}" for n, _, e in held))
                check(not all(w for _, w, _ in held),
                      f"backward {label} {dtype}: the control without the "
                      f"cap's derivative holds the gate ({held})")
                del ctrl
            log(f"  backward {label} {dtype} [{B},{Sq},{Skv},{Hq}/{Hkv},"
                f"{hd}] causal={causal} window={window} softcap={cap}: "
                + "; ".join(parts))
            del q, k, v, do, o, lse, got, ref, refs
    out = {}
    for label, B, Sq, Skv, Hq, Hkv, hd, causal, window, cap in (
            [main] + BWD_FAMILY_CASES):
        dt = torch.bfloat16
        q = _randn((B, Sq, Hq, hd), dt, gen)
        k = _randn((B, Skv, Hkv, hd), dt, gen)
        v = _randn((B, Skv, Hkv, hd), dt, gen)
        do = _randn((B, Sq, Hq, hd), dt, gen)
        kw = dict(causal=causal, window=window, softcap=cap)
        o, lse = fa.flash_attention_cuda(q, k, v, **kw)
        dsum = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        ms = {"flash_attention_dq": time_ms(
                  lambda: fa.flash_attention_dq_cuda(q, k, v, do, lse, dsum,
                                                     **kw)),
              "flash_attention_dkv": time_ms(
                  lambda: fa.flash_attention_dkv_cuda(q, k, v, do, lse, dsum,
                                                      **kw))}
        plain = time_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, do,
                                                           lse, **kw))
        lib = None
        if not cap and not window:
            # SDPA computes the same function only without a softcap (and
            # takes a window only as a mask, which the other cases avoid)
            qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=True)
            dos = do.transpose(1, 2)
            lib = time_ms(lambda: torch.autograd.grad(
                sdpa, (qs, ks, vs), dos, retain_graph=True))
            del qs, ks, vs, sdpa
        for name, (n_bytes, n_ops) in _bwd_work(B, Sq, Skv, Hq, Hkv, hd,
                                                causal, window, 2).items():
            b, by = bound_ms(n_bytes, n_ops, BF16_OPS_S)
            row = dict(shape=[B, Sq, Hq, Hkv, hd], ms=ms[name],
                       plain_ms=plain, bound_ms=b, bound_by=by,
                       library_ms=lib)
            lib_part = (f"sdpa backward {lib:.4f} ms; "
                        f"{_rates(n_ops, ms[name], b, lib, 'sdpa backward')}"
                        if lib is not None else
                        f"no sdpa ({'softcap' if cap else 'window'}); "
                        f"{n_ops / ms[name] / 1e9:.1f} TFLOP/s, "
                        f"{ms[name] / b:.2f}x its bound")
            log(f"  {name} {label} {row['shape']} window={window} "
                f"softcap={cap} bf16: kernel {ms[name]:.4f} ms, bound "
                f"{b:.4f} ms ({by}, {n_ops / 1e9:.2f} GFLOP); plain backward "
                f"{plain:.4f} ms; " + lib_part)
            if label == "training":
                products = (
                    "bf16: tensor-core products (mma.sync), Pᵀ and dSᵀ "
                    "split into three bf16 terms each; float32: CUDA-core "
                    "products; " if name == "flash_attention_dkv" else
                    "bf16: tensor-core products (mma.sync), dS split into "
                    "two bf16 terms; float32: CUDA-core products; ")
                out[name] = dict(
                    row, max_abs_err=err[name], shapes=[],
                    note=products + "plain_ms and library_ms time dQ, dK "
                         "and dV together (flash_attention_bwd_ref; the "
                         "backward of scaled_dot_product_attention); shapes "
                         "holds the training families' cases, softcap "
                         "control " + json.dumps(controls))
            else:
                out[name]["shapes"].append(dict(
                    row, label=label, window=window, softcap=cap))
        if label == "training":
            both = sum(ms.values())
            log(f"  B5 + B6 {both:.4f} ms, {both / lib:.2f}x sdpa backward")
        del q, k, v, do, o, lse, dsum
    torch.cuda.empty_cache()
    return out


# ===========================================================================
# phase 12: training smollm-360m at full width
# ===========================================================================

@contextlib.contextmanager
def _patched_backward(wrap):
    """Within the block, the backward dispatcher the autograd Function
    calls (``flash_attention.ops.flash_attention_bwd``) is ``wrap(fn)``."""
    from repro_torch.kernels.flash_attention import ops

    saved = ops.flash_attention_bwd
    ops.flash_attention_bwd = wrap(saved)
    try:
        yield
    finally:
        ops.flash_attention_bwd = saved


def _dout_scale(grads) -> float:
    """``2**s`` for the integer ``s`` that brings the largest |value| of
    ``grads`` into [0.5, 1) (1 where they are all 0)."""
    m = max(float(t.float().abs().max()) for t in grads)
    return 2.0 ** -math.frexp(m)[1] if m > 0 else 1.0


def _held_reading(fn, args, kw, fault=None):
    """B5/B6 (``fn(*args, use_kernel=True)``, ``args`` = (q, k, v, o, do,
    lse)) against the plain version on the same inputs. Returns the
    kernels' ``(dq, dk, dv)`` and ``(max abs, ulps, scaled ulps)``: the
    largest ``bf16_ulp_err`` over the three, as they come and again with
    dO scaled by the power of two that brings the plain version's largest
    |value| into [0.5, 1). The backward is linear in dO (o and lse are
    fixed, D = rowsum(dO∘O) is linear too), so the scaled outputs are the
    unscaled ones times that power, exactly, and the BF16_ATOL floor no
    longer hides their ulps where the gradients are small. ``fault``, if
    given, is applied to the kernels' dq before it is read: the control."""
    def pair(a):
        out = list(fn(*a, use_kernel=True, **kw))
        if fault is not None:
            out[0] = fault(out[0])
        return out, fn(*a, use_kernel=False, **kw)

    out, ref = pair(args)
    errs = [bf16_ulp_err(a, b) for a, b in zip(out, ref)]
    q, k, v, o, do, lse = args
    out_s, ref_s = pair((q, k, v, o, do * _dout_scale(ref), lse))
    scaled = max(bf16_ulp_err(a, b)[1] for a, b in zip(out_s, ref_s))
    return tuple(out), (max(e[0] for e in errs), max(e[1] for e in errs),
                        scaled)


def _bwd_held(readings: list, first: list):
    """Run B5/B6 and the plain version on the same inputs; append each
    call's ``_held_reading``; keep the first call's ``(fn, args, kw)`` in
    ``first`` (for the control); go on with the kernels' gradients."""
    def wrap(fn):
        def call(*args, use_kernel=None, **kw):
            if not first:
                first.append((fn, args, kw))
            out, reading = _held_reading(fn, args, kw)
            readings.append(reading)
            return out
        return call
    return wrap


def _dq_rounded(n_layers: int, bits: int):
    """The backward as asked, with layer 0's dQ (the last of each step's
    ``n_layers`` calls: the backward runs from the last layer) rounded to
    ``bits`` mantissa bits: the control of the gradient check."""
    calls = [0]

    def wrap(fn):
        def call(*args, **kw):
            dq, dk, dv = fn(*args, **kw)
            calls[0] += 1
            if calls[0] % n_layers == 0:
                dq = _round_mantissa(dq, bits)
            return dq, dk, dv
        return call
    return wrap


def _grads_of(model, cfg, batch, use_kernel) -> tuple:
    """The loss and ``{name: gradient}`` (a copy; zeros for a leaf the loss
    does not reach, such as a shared block a cut depth never applies)."""
    import torch

    from repro_torch.models import transformer as T

    for p in model.parameters():
        p.grad = None
    loss = T.loss_fn(model, cfg, batch, use_kernel)
    loss.backward()
    return float(loss.detach()), {
        n: (p.grad.detach().clone() if p.grad is not None
            else torch.zeros_like(p)) for n, p in model.named_parameters()}


def _leaf_err(a: dict, b: dict) -> tuple[float, str]:
    """The worst leaf's max abs difference over its largest |value|."""
    errs = {n: float((a[n] - b[n]).abs().max()
                     / b[n].abs().max().clamp_min(1e-30)) for n in b}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def _train_batch(pipe, step: int, dev) -> dict:
    import torch

    return {k: torch.from_numpy(v).to(dev)
            for k, v in pipe.batch_at(step).items()}


def _mesh_batch(pipe, step: int, dev, ctx, grad_accum: int = 1):
    """``(blocks, ctx bound to the batch)``: this rank's ``shard_batch``
    blocks of the pipeline's batch ``step``, made on the host and moved to
    ``dev`` (the global batch stays on the host)."""
    import torch

    from repro_torch.models.transformer import shard_batch

    blocks, ctx = shard_batch({k: torch.from_numpy(v) for k, v in
                               pipe.batch_at(step).items()}, ctx, grad_accum)
    return {k: v.to(dev) for k, v in blocks.items()}, ctx


def _resume_check(dev) -> dict:
    """At full width and RESUME_LAYERS layers, with deterministic
    algorithms: 4 straight steps against 2 steps, a CheckpointManager save,
    a restore into a differently seeded state, and 2 more steps."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    cfg = get_config("smollm_360m").with_(n_layers=RESUME_LAYERS, remat=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    pipe = TokenPipeline(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S,
                         seed=SEED)
    step_fn = make_train_step(cfg, opt)

    def fresh(seed):
        return init_train_state(cfg, opt, torch.Generator(device=dev)
                                .manual_seed(seed))

    torch.use_deterministic_algorithms(True)
    try:
        straight = fresh(SEED)
        for s in range(4):
            straight, _ = step_fn(straight, _train_batch(pipe, s, dev))
        state = fresh(SEED)
        for s in range(2):
            state, _ = step_fn(state, _train_batch(pipe, s, dev))
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            mgr = CheckpointManager(d, keep=3, every=2)
            t0 = time.perf_counter()
            check(mgr.maybe_save(2, state), "checkpoint at step 2")
            copy_s = time.perf_counter() - t0
            mgr.wait()
            save_s = time.perf_counter() - t0
            del state
            start, state = mgr.restore_latest(fresh(SEED + 1))
        check(start == 2, f"resumed from step {start}")
        for s in range(2, 4):
            state, _ = step_fn(state, _train_batch(pipe, s, dev))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    a = dict(straight.params.named_parameters())
    b = dict(state.params.named_parameters())
    differ = [f"param {n}" for n in a if not torch.equal(a[n], b[n])]
    for which in ("m", "v"):
        ta, tb = getattr(straight.opt, which), getattr(state.opt, which)
        differ += [f"{which} {n}" for n in ta if not torch.equal(ta[n],
                                                                tb[n])]
    check(int(straight.opt.step) == int(state.opt.step) == 4, "Adam step")
    check(not differ, f"resume not bitwise: {differ[:5]}")
    log(f"  resume at {RESUME_LAYERS} layers: 4 straight steps bitwise "
        f"equal to 2 + save + restore + 2 on all {len(a)} parameters and "
        f"their Adam moments (host copy {copy_s:.2f} s, save "
        f"{save_s:.2f} s)")
    return dict(resume_leaves=3 * len(a) + 1)


def phase_training(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import run_training
    from repro_torch.models import transformer as T
    from repro_torch.training import AdamWConfig, make_train_step

    cfg = get_config("smollm_360m").with_(remat=True)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run = run_training(arch="smollm_360m", preset="full", steps=TRAIN_STEPS,
                       global_batch=TRAIN_B, seq_len=TRAIN_S, seed=SEED,
                       lr=TRAIN_LR, verbose=False, device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = _launches()
    per_step = _per_step(cfg)
    expect = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    log(f"  run_training launches over {TRAIN_STEPS} steps: {launches} "
        f"(expected {expect})")
    check(launches == expect, f"training launches {launches} != {expect}")
    losses = run["losses"]
    check(len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all()),
          f"training losses finite: {losses}")
    log("  losses " + ", ".join(f"{x:.4f}" for x in losses))
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    model = run["state"].params
    n_params = sum(p.numel() for p in model.parameters())
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(p.grad.any())]
    check(not bad, f"parameters without a gradient: {bad[:5]}")
    step_ms = 1e3 * statistics.median(run["step_s"][1:])
    tok_s = TRAIN_B * TRAIN_S / (step_ms / 1e3)
    log(f"  {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{n_params} parameters, remat, lr {TRAIN_LR}")
    log(f"  step ms {', '.join(f'{1e3 * s:.1f}' for s in run['step_s'])} "
        f"(first is warm-up); median {step_ms:.2f} ms, {tok_s:.0f} "
        f"tokens/s; peak device memory {peak_gb:.2f} GB; run_training "
        f"{total_s:.1f} s with init; every parameter has a nonzero "
        "gradient")

    # every B5/B6 call of one step held against the plain version
    pipe = TokenPipeline(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S,
                         seed=SEED)
    batch = _train_batch(pipe, TRAIN_STEPS, dev)
    held, first = [], []
    with _patched_backward(_bwd_held(held, first)):
        _grads_of(model, cfg, batch, None)
    check(len(held) == cfg.n_layers, f"held {len(held)} backward calls")
    call_err, call_ulps, call_scaled = (max(h[i] for h in held)
                                        for i in range(3))
    with torch.no_grad():
        _, ctrl_call = _held_reading(*first[0], fault=lambda dq:
                                     _round_mantissa(dq, CALL_CONTROL_BITS))
    del first
    log(f"  bf16, every B5/B6 call of one step ({len(held)} calls) vs the "
        f"plain version on its inputs: max abs {call_err:.3g}, max "
        f"{call_ulps:.3g} ulps beyond {BF16_ATOL}; with dO scaled so that "
        f"the largest gradient is in [0.5, 1): max {call_scaled:.3g} ulps "
        f"(per call: {', '.join(f'{h[2]:.3g}' for h in held)}); control "
        f"(the first call's dq at {CALL_CONTROL_BITS} mantissa bits): "
        f"{ctrl_call[1]:.3g} ulps, scaled {ctrl_call[2]:.3g}")
    check(call_ulps <= BF16_ULPS, f"training backward calls beyond "
          f"{BF16_ULPS} bf16 ulps + {BF16_ATOL} ({call_ulps:.3g})")
    check(call_scaled <= BF16_ULPS, f"training backward calls at scaled dO "
          f"beyond {BF16_ULPS} bf16 ulps + {BF16_ATOL} ({call_scaled:.3g})")
    check(ctrl_call[2] > BF16_ULPS, f"backward call control at scaled dO "
          f"within {BF16_ULPS} bf16 ulps ({ctrl_call[2]:.3g})")

    # where one step's device time goes
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=10)
    step_fn = make_train_step(cfg, opt)
    state = run["state"]
    batch = _train_batch(pipe, TRAIN_STEPS + 1, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    by_kernel = device_ms_by_kernel(lambda: step_fn(state, batch))
    prof_wall = 1e3 * (time.perf_counter() - t0)
    busy = sum(by_kernel.values())
    ours = {name: sum(t for k, t in by_kernel.items() if kern in k)
            for name, kern in (("B4", "flash_attention_fwd_"),
                               ("B5", "flash_attention_dq_"),
                               ("B6", "flash_attention_dkv_"))}
    n_calls = dict(zip(ours, (per_step["flash_attention"],
                              per_step["flash_attention_dq"],
                              per_step["flash_attention_dkv"])))
    log(f"  one step under the profiler: device busy {busy:.2f} ms, "
        f"{100 * busy / step_ms:.1f} % of the median step {step_ms:.2f} ms "
        f"(the profiled step took {prof_wall:.0f} ms with the profiler's "
        "own cost); device ms per step "
        + ", ".join(f"{k} {t:.2f} ms ({100 * t / busy:.1f} %, "
                    f"{n_calls[k]} x {t / n_calls[k]:.3f} ms)"
                    for k, t in ours.items()))
    gemm = sum(t for k, t in by_kernel.items()
               if any(g in k.lower() for g in ("nvjet", "gemm", "xmma",
                                               "cutlass")))
    log(f"  of the device time: B4-B6 {sum(ours.values()):.2f} ms, GEMMs "
        f"{gemm:.2f} ms, everything else (elementwise, casts, reductions, "
        f"the optimizer) {busy - sum(ours.values()) - gemm:.2f} ms, over "
        f"{len(by_kernel)} kernel names")
    for name, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {t:9.3f} ms  {name[:90]}")
    del run, state, model, batch
    torch.cuda.empty_cache()

    # float32 gradients: kernels vs plain, and the control
    cfg32 = cfg.with_(dtype="float32")
    model = T.init_params(cfg32, torch.Generator(device=dev)
                          .manual_seed(SEED))
    batch = _train_batch(TokenPipeline(cfg32, global_batch=GRAD_B,
                                       seq_len=GRAD_S, seed=SEED), 0, dev)
    _, g_kern = _grads_of(model, cfg32, batch, None)
    _, g_plain = _grads_of(model, cfg32, batch, False)
    err, worst = _leaf_err(g_kern, g_plain)
    del g_kern
    with _patched_backward(_dq_rounded(cfg.n_layers, GRAD_CONTROL_BITS)):
        _, g_ctrl = _grads_of(model, cfg32, batch, False)
    ctrl, ctrl_worst = _leaf_err(g_ctrl, g_plain)
    log(f"  float32 gradients of a {GRAD_B}x{GRAD_S}-token step, kernels "
        f"vs plain: worst leaf {err:.3g} of its largest value ({worst}); "
        f"control (layer 0's dQ at {GRAD_CONTROL_BITS} mantissa bits) "
        f"{ctrl:.3g} ({ctrl_worst}); limit {GRAD_TOL}")
    check(err <= GRAD_TOL, f"float32 gradients kernels vs plain {err}")
    check(ctrl > GRAD_TOL, f"gradient control {ctrl} within {GRAD_TOL}")
    del model, g_plain, g_ctrl, batch
    torch.cuda.empty_cache()

    out = dict(step_ms=step_ms, tokens_per_s=tok_s, peak_gb=peak_gb,
               busy_share=busy / step_ms, launches=launches,
               call_ulps=call_ulps, call_ulps_scaled=call_scaled,
               call_control_scaled=ctrl_call[2], grad_err=err,
               grad_control=ctrl,
               losses=losses)
    out.update(_resume_check(dev))
    torch.cuda.empty_cache()
    return out


# ===========================================================================
# phase 19: the SSD scan's backward kernel
# ===========================================================================

def _ssd_bwd_work(B, L, H, P, N, chunk, with_init, with_dfinal
                  ) -> tuple[float, float]:
    """``(bytes, operations)`` one backward needs, from
    ``ssd_scan.ops.ssd_scan_bwd_cost``."""
    from repro_torch.kernels.ssd_scan import ops as ss_ops

    cost = ss_ops.ssd_scan_bwd_cost(B, L, H, P, N, chunk, with_dfinal)
    return cost.bytes, cost.flops


def _ssd_bwd_scratch_gb(B, L, H, P, N, chunk) -> float:
    """GB of scratch the backward kernel's wrapper allocates a call."""
    from repro_torch.kernels.ssd_scan import ops

    return sum(t.numel() for t in ops._bwd_scratch(
        B, L, H, P, N, chunk, "meta")) * 4 / 1e9


def _ssd_bwd_args(x, dtA, b, c, s0, chunk, use_kernel):
    """The padded inputs and the forward's entering states and chunk decay
    (B8's scratch for the kernel, ssd_chunked_steps's for the plain
    version)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ssd_scan as ss

    pad = (-x.shape[1]) % chunk
    x, dtA, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                    for t in (x, dtA, b, c))
    steps = (ss.ssd_scan_cuda_steps(x, dtA, b, c, chunk=chunk,
                                    initial_state=s0) if use_kernel
             else ss.ssd_chunked_steps(x, dtA, b, c, chunk, s0))
    return x, dtA, b, c, steps["entering_states"], steps["chunk_decay"]


def _head_dropped(x, dy, head: int) -> tuple:
    """x and dy with one head's values zeroed: inputs of the backward's
    control, whose db and dc lose that head's share of the sums over
    heads."""
    x, dy = x.clone(), dy.clone()
    x[:, :, head] = 0
    dy[:, :, head] = 0
    return x, dy


def _host_ms_by_op(fn, top: int = 6) -> list:
    """``[(name, host ms)]``: the largest self CPU times of the operations
    and CUDA runtime calls of one ``fn()`` call after a warm-up call, from
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_cpu_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU
            and "Synchronize" not in e.key
            and "Activity Buffer" not in e.key]  # the profiler's own
    return sorted(rows, key=lambda kv: -kv[1])[:top]


def phase_ssd_bwd_kernel(dev) -> tuple:
    """The backward kernel against the float64 plain backward
    (ssd_chunked_bwd), two calls bitwise, and a control with one head's x
    and dy zeroed whose db and dc must read above the gate; numbers at the
    mamba2 training shape, with the host's share of a call; then B8 and
    the backward on head blocks (:func:`_ssd_head_blocks`). Returns the
    backward's row and B8's head-block reading."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    # (label, B, L, H, P, N, chunk, initial state, dfinal)
    cases = [("mamba2 training", TRAIN_B, TRAIN_S, 80, 64, 128, 256, False,
              False),
             ("zamba2 training", TRAIN_B, TRAIN_S, 80, 64, 64, 256, False,
              False),
             ("1 chunk, initial state, dfinal", 2, 256, 4, 64, 128, 256,
              True, True),
             ("ragged L, initial state, dfinal", 1, 300, 3, 64, 64, 256,
              True, True),
             ("chunk 40, initial state", 1, 200, 2, 64, 128, 40, True,
              False),
             ("P=N=16, initial state, dfinal", 4, 16, 8, 16, 16, 8, True,
              True),
             ("P=N=16, 5 chunks, dfinal", 2, 40, 8, 16, 16, 8, False, True),
             ("P=N=16 ragged", 1, 21, 3, 16, 16, 8, True, False)]
    names = ("dx", "ddtA", "db", "dc", "dinit")
    rows, err = {}, 0.0
    for label, B, L, H, P, N, chunk, with_init, with_dfinal in cases:
        x, dtA, b, c = _ssd_inputs(B, L, H, P, N, gen)
        dy = torch.randn((B, L, H, P), generator=gen, device=dev)
        s0 = torch.randn((B, H, P, N), generator=gen, device=dev) \
            if with_init else None
        dfin = torch.randn((B, H, P, N), generator=gen, device=dev) \
            if with_dfinal else None
        pad = (-L) % chunk
        dyp = F.pad(dy, (0, 0, 0, 0, 0, pad))
        xp, ap, bp, cp, ent, dec = _ssd_bwd_args(x, dtA, b, c, s0, chunk,
                                                 True)

        def kernel():
            return ss.ssd_scan_bwd(xp, ap, bp, cp, dyp, chunk=chunk,
                                   entering_states=ent, chunk_decay=dec,
                                   dfinal=dfin, use_kernel=True)

        n0 = ss.LAUNCHES["ssd_scan_bwd"]
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        check(ss.LAUNCHES["ssd_scan_bwd"] == n0 + 2,
              f"ssd_scan_bwd {label}: launches")
        d = [t.double() for t in (xp, ap, bp, cp, dyp)]
        ref = ss.ssd_chunked_bwd(
            *d, None if dfin is None else dfin.double(),
            None if s0 is None else s0.double(), chunk=chunk)
        errs, parts = {}, []
        for name, g, a, r in zip(names, got, again, ref):
            if name != "dinit":
                g, a, r = g[:, :L], a[:, :L], r[:, :L]
            check(bool(torch.isfinite(g).all()),
                  f"ssd_scan_bwd {label} {name} finite")
            check(torch.equal(g, a), f"ssd_scan_bwd {label} {name}: two "
                  "calls differ")
            scale = float(r.abs().max())
            errs[name] = float((g.double() - r).abs().max()) / max(scale,
                                                                 1e-300)
            parts.append(f"{name} {errs[name]:.3g} (max|.| {scale:.4g})")
            if name != "dinit" or with_init:
                err = max(err, float((g.double() - r).abs().max()))
        # control: one head's x and dy zeroed, db and dc against the plain
        # backward of the full inputs
        xd, dyd = _head_dropped(xp, dyp, H // 2)
        dropped = ss.ssd_scan_bwd(xd, ap, bp, cp, dyd, chunk=chunk,
                                  entering_states=ent, chunk_decay=dec,
                                  dfinal=dfin, use_kernel=True)
        ctrl = max(float((g[:, :L].double() - r[:, :L]).abs().max()
                         / r[:, :L].abs().max()) for g, r in
                   zip(dropped[2:4], ref[2:4]))
        log(f"  ssd_scan_bwd {label} [{B},{L},{H},{P},{N}] chunk {chunk}: "
            "scale-free error vs float64 plain " + ", ".join(parts)
            + f"; two calls bit-equal; control (head {H // 2}'s x and dy "
            f"zeroed) db/dc {ctrl:.3g}; limit {SSD_TOL}")
        check(all(e <= SSD_TOL for e in errs.values()),
              f"ssd_scan_bwd {label} vs float64 plain: {errs}")
        check(ctrl > SSD_TOL, f"ssd_scan_bwd {label}: control with a head "
              f"dropped {ctrl} within {SSD_TOL}")
        del got, again, ref, d, xd, dyd, dropped
        if not label.endswith("training"):
            continue
        ms = time_ms(kernel)
        dev_ms = device_ms_total(kernel)
        # the host's share: one call's enqueue on the host clock (no sync),
        # and its largest host-side operations under the profiler
        torch.cuda.synchronize()
        enq = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            kernel()
            enq.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
        host_ops = _host_ms_by_op(kernel)
        pp = _ssd_bwd_args(x, dtA, b, c, s0, chunk, False)
        plain = time_ms(lambda: ss.ssd_chunked_bwd(
            *pp[:4], dyp, dfin, s0, chunk=chunk, entering_states=pp[4],
            chunk_decay=pp[5]))
        leaves = [t.detach().clone().requires_grad_() for t in pp[:4]]
        y, _ = ss.ssd_chunked(*leaves, chunk, s0)
        autograd = time_ms(lambda: torch.autograd.grad(
            y, leaves, dyp, retain_graph=True))
        del y, leaves, pp
        n_bytes, n_ops = _ssd_bwd_work(B, L, H, P, N, chunk, with_init,
                                       with_dfinal)
        bnd, by = bound_ms(n_bytes, n_ops)
        p_bnd, p_by = bound_ms(n_bytes, 3 * n_ops, BF16_OPS_S)
        log(f"    kernel {ms:.4f} ms (device {dev_ms:.4f} ms over its six "
            f"launches), ssd_chunked_bwd {plain:.4f} ms, autograd of "
            f"ssd_chunked {autograd:.4f} ms, bound {bnd:.4f} ms ({by}: "
            f"{n_ops / 1e9:.4g} GFLOP at the float32 peak, "
            f"{n_bytes / 1e9:.4g} GB: {1e3 * n_bytes / HBM_BYTES_S:.4f} ms); "
            f"kernel at {bnd / ms:.3g} of the bound; the split plan's "
            f"3 x {n_ops / 1e9:.4g} GFLOP of bf16 {p_bnd:.4f} ms ({p_by}); "
            f"scratch {_ssd_bwd_scratch_gb(B, L, H, P, N, chunk):.4f} GB")
        log(f"    host: one call's enqueue {statistics.median(enq):.4f} ms "
            f"(median of {REPS}, no sync), events less device time "
            f"{ms - (dev_ms or 0.0):.4f} ms; its largest host operations "
            + ", ".join(f"{k} {t:.4f} ms" for k, t in host_ops))
        rows[label] = dict(shape=[B, L, H, P, N], ms=ms, device_ms=dev_ms,
                           plain_ms=plain, autograd_ms=autograd,
                           bound_ms=bnd, bound_by=by, library_ms=None,
                           plan_bound_ms=p_bnd, plan_bound_by=p_by,
                           host_enqueue_ms=statistics.median(enq))
        del x, dtA, b, c, dy, dyp, xp, ap, bp, cp, ent, dec
        torch.cuda.empty_cache()
    z = rows["zamba2 training"]
    blocks = _ssd_head_blocks(dev)
    note = (f"zamba2 shape {z['shape']}: {z['ms']:.4f} ms (device "
            f"{z['device_ms']:.4f}; host enqueue {z['host_enqueue_ms']:.4f}), "
            f"bound {z['bound_ms']:.4f} (plan {z['plan_bound_ms']:.4f}) "
            f"({z['bound_by']}), ssd_chunked_bwd {z['plain_ms']:.4f}, "
            f"autograd of ssd_chunked {z['autograd_ms']:.4f}; no Pallas "
            "counterpart (the reference differentiates jnp ssd_chunked)")
    return {"ssd_scan_bwd": dict(rows["mamba2 training"], max_abs_err=err,
                                 note=note, head_block=blocks["bwd"])}, \
        blocks["fwd"]


def _ssd_head_blocks(dev) -> dict:
    """B8 and the SSD backward on HEAD_BLOCKS head blocks of the mamba2
    training shape, as the model ranks of the tensor-parallel Mamba block
    call them (B and C whole, each block's own forward scratch): y, the
    final state, dx and ddtA bit-equal to the same heads of the whole
    call; the blocks' db/dc partials, summed in block order, within
    SSD_TOL of the whole call's (its sums over heads are on chip, in head
    order); a control with one head's x and dy zeroed in one block, whose
    sum must read above it; each block launch's event ms beside the whole
    call's."""
    import torch

    from repro_torch.kernels import ssd_scan as ss

    B, L, H, P, N, chunk = TRAIN_B, TRAIN_S, 80, 64, 128, 256
    k = H // HEAD_BLOCKS
    gen = torch.Generator(device=dev).manual_seed(SEED + 1919)
    x, dtA, b, c = _ssd_inputs(B, L, H, P, N, gen)
    dy = torch.randn((B, L, H, P), generator=gen, device=dev)

    def fwd(x_, a_):
        return ss.ssd_scan_cuda_steps(x_, a_, b, c, chunk=chunk)

    def bwd(x_, a_, dy_, st):
        return ss.ssd_scan_bwd(x_, a_, b, c, dy_, chunk=chunk,
                               entering_states=st["entering_states"],
                               chunk_decay=st["chunk_decay"],
                               use_kernel=True)

    whole = fwd(x, dtA)
    gw = bwd(x, dtA, dy, whole)
    sums = {"blocks": [None, None], "control": [None, None]}
    times = {"fwd": [], "bwd": []}
    for j in range(HEAD_BLOCKS):
        hs = slice(j * k, (j + 1) * k)
        xs, as_, dys = (t[:, :, hs].contiguous() for t in (x, dtA, dy))
        st = fwd(xs, as_)
        g = bwd(xs, as_, dys, st)
        for name, got, want in (("y", st["y"], whole["y"][:, :, hs]),
                                ("final state", st["final_state"],
                                 whole["final_state"][:, hs]),
                                ("dx", g[0], gw[0][:, :, hs]),
                                ("ddtA", g[1], gw[1][:, :, hs])):
            check(torch.equal(got, want), f"head block {j} ({k} of {H} "
                  f"heads): {name} differs from the whole call's: max "
                  f"{float((got - want).abs().max())}")
        ctrl = g
        if j == HEAD_BLOCKS // 2:
            xd, dyd = _head_dropped(xs, dys, k // 2)
            ctrl = bwd(xd, as_, dyd, st)
            del xd, dyd
        for key, gg in (("blocks", g), ("control", ctrl)):
            sums[key] = [t if acc is None else acc + t
                         for acc, t in zip(sums[key], gg[2:4])]
        times["fwd"].append(time_ms(lambda: fwd(xs, as_)))
        times["bwd"].append(time_ms(lambda: bwd(xs, as_, dys, st)))
        del xs, as_, dys, st, g, ctrl
    torch.cuda.synchronize()

    def err(parts):
        return max(float((p - w).abs().max() / w.abs().max())
                   for p, w in zip(parts, gw[2:4]))

    e, ctrl = err(sums["blocks"]), err(sums["control"])
    whole_ms = {"fwd": time_ms(lambda: fwd(x, dtA)),
                "bwd": time_ms(lambda: bwd(x, dtA, dy, whole))}
    log(f"  head blocks [{B},{L},{k} of {H},{P},{N}] chunk {chunk} "
        f"({HEAD_BLOCKS} blocks, B and C whole): y, final state, dx and "
        f"ddtA bit-equal to the whole call's heads; db/dc summed over the "
        f"blocks in order {e:.3g} of the whole call's largest |value| "
        f"(its sums over heads on chip), control (one head's x and dy "
        f"zeroed in block {HEAD_BLOCKS // 2}) {ctrl:.3g}; limit {SSD_TOL}")
    for kind, name in (("fwd", "B8"), ("bwd", "SSD backward")):
        log(f"    {name} a head block " + ", ".join(
            f"{t:.4f}" for t in times[kind]) + f" ms (events); the whole "
            f"call {whole_ms[kind]:.4f} ms; the blocks together "
            f"{sum(times[kind]):.4f} ms")
    check(e <= SSD_TOL, f"head blocks' db/dc {e} above {SSD_TOL}")
    check(ctrl > SSD_TOL, f"head-block control {ctrl} within {SSD_TOL}")
    del x, dtA, b, c, dy, whole, gw
    torch.cuda.empty_cache()
    return {kind: dict(shape=[B, L, k, P, N], blocks=HEAD_BLOCKS,
                       ms=times[kind], whole_ms=whole_ms[kind],
                       db_dc_err=e, control=ctrl)
            for kind in ("fwd", "bwd")}


# ===========================================================================
# phase 20: training mamba2-2.7b and zamba2-2.7b
# ===========================================================================

@contextlib.contextmanager
def _plain_calls(ops, names, calls: dict):
    """Within the block, count in ``calls`` every call of the plain
    versions ``names`` that a kernels' module ``ops`` binds by name (which
    its dispatchers and autograd Function could reach)."""
    saved = {n: getattr(ops, n) for n in names}

    def counted(name):
        def call(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return saved[name](*args, **kw)
        return call

    for n in names:
        setattr(ops, n, counted(n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


@contextlib.contextmanager
def _scan_rounded(bits: int):
    """Within the block, every Mamba layer's scan output rounded to
    ``bits`` mantissa bits, and the gradient that reaches it rounded the
    same way: a scan whose output and output gradient are held in that
    precision, the control of the float32 gradient check."""
    import torch

    from repro_torch.models import layers

    class Rounded(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y):
            return _round_mantissa(y, bits)

        @staticmethod
        def backward(ctx, g):
            return _round_mantissa(g, bits)

    saved = layers.ssd

    def rounded(*args, **kw):
        y, state = saved(*args, **kw)
        return Rounded.apply(y), state

    layers.ssd = rounded
    try:
        yield
    finally:
        layers.ssd = saved


@contextlib.contextmanager
def _ssd_bwd_forced(forced: bool):
    """Within the block, the SSD backward's dispatcher runs the kernel
    (True) or the plain version (False), whatever the forward ran."""
    from repro_torch.kernels.ssd_scan import ops

    saved = ops.ssd_scan_bwd

    def call(*args, use_kernel=None, **kw):
        return saved(*args, use_kernel=forced, **kw)

    ops.ssd_scan_bwd = call
    try:
        yield
    finally:
        ops.ssd_scan_bwd = saved


@contextlib.contextmanager
def _ssd_bwd_held(errs: list, controls: list):
    """Within the block, every call of the SSD backward's dispatcher that
    runs the kernel is run again with the plain version on the same
    inputs (the forward's entering states and chunk decay included), and
    the largest scale-free error over its five gradients is appended to
    ``errs``; the first such call also runs the kernel with one head's x
    and dy zeroed, and the larger scale-free error of its db and dc
    against the plain version of the full inputs is appended to
    ``controls``. The kernel's gradients go on."""
    from repro_torch.kernels.ssd_scan import ops

    saved = ops.ssd_scan_bwd

    def call(*args, use_kernel=None, **kw):
        out = saved(*args, use_kernel=use_kernel, **kw)
        if args[0].is_cuda if use_kernel is None else use_kernel:
            ref = saved(*args, use_kernel=False, **kw)
            errs.append(max(_ssd_err((o,), (r,)) for o, r in zip(out, ref)))
            if not controls:
                x, dtA, b, c, dy = args
                xd, dyd = _head_dropped(x, dy, x.shape[2] // 2)
                dropped = saved(xd, dtA, b, c, dyd, use_kernel=use_kernel,
                                **kw)
                controls.append(max(_ssd_err((o,), (r,)) for o, r in
                                    zip(dropped[2:4], ref[2:4])))
        return out

    ops.ssd_scan_bwd = call
    try:
        yield
    finally:
        ops.ssd_scan_bwd = saved


def _ssm_training(dev, arch: str) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch.train import run_training
    from repro_torch.models import transformer as T
    from repro_torch.training import AdamWConfig, make_train_step

    cfg = get_config(arch).with_(remat=True)
    n_shared = _attention_layers(cfg)
    per_step = _per_step(cfg)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    plain_calls = {}
    t0 = time.perf_counter()
    with _plain_calls(ss.ops, ("ssd_chunked_bwd", "ssd_chunked_steps"),
                      plain_calls):
        run = run_training(arch=arch, preset="full", steps=TRAIN_STEPS,
                           global_batch=TRAIN_B, seq_len=TRAIN_S, seed=SEED,
                           lr=TRAIN_LR, verbose=False, device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = _launches()
    expect = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    log(f"  run_training launches over {TRAIN_STEPS} steps: {launches} "
        f"(expected {expect}); plain SSD calls {plain_calls}")
    check(launches == expect, f"{arch} training launches {launches} != "
          f"{expect}")
    check(not plain_calls, f"{arch}: the plain SSD scan ran on the card's "
          f"training path: {plain_calls}")
    losses = run["losses"]
    check(len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all()),
          f"{arch} training losses finite: {losses}")
    log("  losses " + ", ".join(f"{x:.4f}" for x in losses))
    check(losses[-1] < losses[0], f"{arch} loss did not fall: {losses}")
    model = run["state"].params
    n_params = sum(p.numel() for p in model.parameters())
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(p.grad.any())]
    check(not bad, f"{arch} parameters without a gradient: {bad[:5]}")
    step_ms = 1e3 * statistics.median(run["step_s"][1:])
    tok_s = TRAIN_B * TRAIN_S / (step_ms / 1e3)
    log(f"  {cfg.name}: {cfg.n_layers} Mamba2 layers"
        + (f" + {n_shared} shared-block applications" if n_shared else "")
        + f", d={cfg.d_model}, {cfg.ssm_heads} heads x {cfg.ssm_head_dim},"
        f" N={cfg.ssm_state}, {n_params} parameters, remat, lr {TRAIN_LR}")
    log(f"  step ms {', '.join(f'{1e3 * s:.1f}' for s in run['step_s'])} "
        f"(first is warm-up); median of steps 2-{TRAIN_STEPS} "
        f"{step_ms:.2f} ms, {tok_s:.0f} tokens/s; peak device memory "
        f"{peak_gb:.2f} GB; run_training {total_s:.1f} s with init; every "
        "parameter has a nonzero gradient")

    # where one step's device time goes
    pipe = TokenPipeline(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S,
                         seed=SEED)
    step_fn = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                                               total_steps=10))
    state = run["state"]
    batch = _train_batch(pipe, TRAIN_STEPS, dev)
    torch.cuda.synchronize()
    by_kernel = device_ms_by_kernel(lambda: step_fn(state, batch))
    busy = sum(by_kernel.values())
    ours = {name: sum(t for k, t in by_kernel.items() if re.search(pat, k))
            for name, pat in (
                ("B8", r"ssd_(cb|states|recurrence|output)(_small)?_kernel"),
                ("SSD backward", r"ssd_bwd_"),
                ("B4", r"flash_attention_fwd_"),
                ("B5", r"flash_attention_dq_"),
                ("B6", r"flash_attention_dkv_"))}
    gemm = sum(t for k, t in by_kernel.items()
               if any(g in k.lower() for g in ("nvjet", "gemm", "xmma",
                                               "cutlass")))
    rest = busy - sum(ours.values()) - gemm
    log(f"  one step under the profiler: device busy {busy:.2f} ms, "
        f"{100 * busy / step_ms:.1f} % of the median step {step_ms:.2f} "
        "ms; device ms per step "
        + ", ".join(f"{k} {t:.2f} ms ({100 * t / max(busy, 1e-9):.1f} %)"
                    for k, t in ours.items())
        + f", GEMMs {gemm:.2f} ms, everything else {rest:.2f} ms over "
        f"{len(by_kernel)} kernel names")
    for name, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {t:9.3f} ms  {name[:90]}")
    del step_fn

    # every SSD backward call of one bf16 step against the plain version
    held, held_ctrl = [], []
    with _ssd_bwd_held(held, held_ctrl):
        _grads_of(model, cfg, batch, None)
    log(f"  bf16, every SSD backward call of one step ({len(held)} calls) "
        f"vs the plain backward on its inputs: scale-free error max "
        f"{max(held):.3g}, median {statistics.median(held):.3g}; control "
        f"(the first call with one head's x and dy zeroed) db/dc "
        f"{held_ctrl[0]:.3g}; limit {SSD_TOL}")
    check(len(held) == cfg.n_layers, f"{arch}: held {len(held)} backward "
          "calls")
    check(max(held) <= SSD_TOL, f"{arch} SSD backward calls {max(held)}")
    check(held_ctrl[0] > SSD_TOL, f"{arch} SSD backward control "
          f"{held_ctrl[0]} within {SSD_TOL}")
    del run, state, model, batch
    torch.cuda.empty_cache()

    # float32 at full width, depth cut: kernels vs plain, and the control
    cfg32 = cfg.with_(dtype="float32", n_layers=SSM_GRAD_DEPTH[arch])
    model = T.init_params(cfg32, torch.Generator(device=dev)
                          .manual_seed(SEED))
    batch = _train_batch(TokenPipeline(cfg32, global_batch=GRAD_B,
                                       seq_len=GRAD_S, seed=SEED), 0, dev)
    l_kern, g_kern = _grads_of(model, cfg32, batch, None)
    l_plain, g_plain = _grads_of(model, cfg32, batch, False)
    err, worst = _leaf_err(g_kern, g_plain)
    rest = _leaf_err(g_kern, {n: g for n, g in g_plain.items()
                              if not n.endswith(("A_log", "dt_bias"))})
    del g_kern
    # the two kernels apart: B8 with the plain backward, and the plain
    # forward with the backward kernel
    apart = {}
    for label, flag, forced in (("B8 alone", None, False),
                                ("the backward kernel alone", False, True)):
        with _ssd_bwd_forced(forced):
            _, g = _grads_of(model, cfg32, batch, flag)
        apart[label] = _leaf_err(g, g_plain)
        del g
    with _scan_rounded(SSM_CONTROL_BITS):
        _, g_ctrl = _grads_of(model, cfg32, batch, False)
    ctrl, ctrl_worst = _leaf_err(g_ctrl, g_plain)
    loss_err = abs(l_kern - l_plain) / abs(l_plain)
    log(f"  float32 at full width and {SSM_GRAD_DEPTH[arch]} Mamba layers, "
        f"a {GRAD_B}x{GRAD_S}-token step, kernels vs plain: loss "
        f"{l_kern:.6f} vs {l_plain:.6f} ({loss_err:.3g} relative), worst "
        f"gradient leaf {err:.3g} of its largest value ({worst}), worst "
        f"but A_log and dt_bias {rest[0]:.3g} ({rest[1]}); "
        + "; ".join(f"{k} {e:.3g} ({n})" for k, (e, n) in apart.items())
        + f"; control (every layer's scan output and its gradient at "
        f"{SSM_CONTROL_BITS} mantissa bits) {ctrl:.3g} ({ctrl_worst}); "
        f"limit {SSM_GRAD_TOL}")
    check(loss_err <= SSM_GRAD_TOL, f"{arch} float32 loss kernels vs plain "
          f"{loss_err}")
    check(err <= SSM_GRAD_TOL, f"{arch} float32 gradients kernels vs plain "
          f"{err}")
    check(ctrl > SSM_GRAD_TOL, f"{arch} gradient control {ctrl} within "
          f"{SSM_GRAD_TOL}")
    del model, g_plain, g_ctrl, batch
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, tokens_per_s=tok_s, peak_gb=peak_gb,
                busy_share=busy / step_ms, device_ms=ours, gemm_ms=gemm,
                launches=launches, losses=losses, call_err=max(held),
                call_control=held_ctrl[0], grad_err=err, grad_control=ctrl,
                n_params=n_params)


def phase_ssm_training(dev) -> dict:
    return {arch: _ssm_training(dev, arch) for arch in SSM_TRAINED}


# ===========================================================================
# phase 21: every remaining family trains
# ===========================================================================

def _no_plain_attention(calls: dict):
    """:func:`_plain_calls` over the attention's plain versions."""
    from repro_torch.kernels.flash_attention import ops

    return _plain_calls(ops, ("attention_ref", "flash_attention_bwd_ref"),
                        calls)


def _attention_layers(cfg) -> int:
    """Attention layers a forward runs (shared-block applications in a
    hybrid)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return 0 if cfg.family == "ssm" else cfg.n_layers


def _per_step(cfg, save_attn: bool = False) -> dict:
    """Each kernel's launches in one remat training step: B4 twice an
    attention layer (forward and recompute; once under save_attn), B5 and
    B6 once; B8 twice and the SSD backward once a Mamba layer."""
    n_attn = _attention_layers(cfg)
    n_mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    return {"flash_attention": (1 if save_attn else 2) * n_attn,
            "flash_attention_dq": n_attn, "flash_attention_dkv": n_attn,
            "gqa_decode": 0, "ssd_scan": 2 * n_mamba,
            "ssd_scan_bwd": n_mamba}


def _launches() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import ssd_scan as ss

    return {**fa.LAUNCHES, **gd.LAUNCHES, **ss.LAUNCHES}


def _reset_launches() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import ssd_scan as ss

    for mod in (fa, gd, ss):
        mod.reset_launch_counts()


def _without_gradient(model, cfg) -> list:
    """Parameters with no nonzero gradient, but for an audio model's token
    table, which its frames never reach (the reference's gradient there is
    zero too)."""
    return [n for n, p in model.named_parameters()
            if (p.grad is None or not bool(p.grad.any()))
            and not (n == "tok" and cfg.frontend == "audio")]


def _trained_checks(what: str, cfg, losses, launches, expect, plain,
                    model, first_batch) -> float:
    """The launch counts, no plain attention, finite losses, every
    parameter with a gradient, and the loss falling: the trained model's
    loss on the first step's batch below the first step's (the same
    targets: hubert's pipeline draws each batch's targets at random, so
    from batch to batch its loss falls by less than it varies). Returns
    that loss."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as T

    log(f"  launches {launches} (expected {expect}); plain attention calls "
        f"{plain}")
    check(launches == expect, f"{what} launches {launches} != {expect}")
    check(not plain, f"{what}: the plain attention ran on the card's "
          f"training path: {plain}")
    check(bool(np.isfinite(losses).all()), f"{what} losses finite: {losses}")
    bad = _without_gradient(model, cfg)
    check(not bad, f"{what} parameters without a gradient: {bad[:5]}")
    with torch.no_grad():
        again = float(T.loss_fn(model, cfg, first_batch))
    log("  losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f"; the first batch's loss after the last step {again:.4f}")
    check(bool(np.isfinite(again)) and again < losses[0],
          f"{what} loss did not fall: {losses[0]} on the first batch "
          f"before the first step, {again} after the last")
    return again


def _family_training(dev, arch: str) -> dict:
    """TRAIN_STEPS AdamW steps through make_train_step at full width and
    the depth FAMILY_TRAINED gives, then one float32 step at
    FAMILY_GRAD_DEPTH with kernels against the same step with the plain
    versions, and its control."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import transformer as T
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    depth, B, S = FAMILY_TRAINED[arch]
    full = get_config(arch)
    cfg = full.with_(remat=True, **({"n_layers": depth} if depth else {}))
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=10)
    pipe = TokenPipeline(cfg, global_batch=B, seq_len=S, seed=SEED)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_train_state(cfg, opt, torch.Generator(device=dev)
                             .manual_seed(SEED))
    step_fn = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated(dev) / 1e9
    n_params = sum(p.numel() for p in state.params.parameters())
    _reset_launches()
    plain, losses, step_s, peaks = {}, [], [], []
    with _no_plain_attention(plain):
        for step in range(TRAIN_STEPS):
            t = time.perf_counter()
            state, metrics = step_fn(state, _train_batch(pipe, step, dev))
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t)
            peaks.append(torch.cuda.max_memory_allocated(dev) / 1e9)
    launches = _launches()
    expect = {k: n * TRAIN_STEPS for k, n in _per_step(cfg).items()}
    cut = (f"{cfg.n_layers} of its {full.n_layers} layers" if depth
           else f"{cfg.n_layers} layers")
    log(f"  {cfg.name}: {cut}, d={cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads x {cfg.head_dim}"
        + (f", {cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}"
           if cfg.n_experts else f", d_ff {cfg.d_ff}")
        + f", {n_params} parameters ({n_params * 16 / 1e9:.1f} GB of f32 "
        f"weights, gradients and Adam moments; {state_gb:.1f} GB allocated "
        f"after init, {init_s:.1f} s), {B} x {S} positions a step, remat, "
        f"lr {TRAIN_LR}")
    again = _trained_checks(arch, cfg, losses, launches, expect, plain,
                            state.params, _train_batch(pipe, 0, dev))
    step_ms = 1e3 * statistics.median(step_s[1:])
    tok_s = B * S / (step_ms / 1e3)
    log(f"  step ms {', '.join(f'{1e3 * x:.1f}' for x in step_s)} (first "
        f"is warm-up); median of steps 2-{TRAIN_STEPS} {step_ms:.2f} ms, "
        f"{tok_s:.0f} tokens/s; peak device memory after the first step "
        f"{peaks[0]:.2f} GB, over the run {peaks[-1]:.2f} GB; every "
        "parameter has a nonzero gradient")
    check(peaks[0] <= FAMILY_PEAK_GB, f"{arch} first step's peak "
          f"{peaks[0]:.2f} GB above {FAMILY_PEAK_GB} GB: halve its batch")

    # where one step's device time goes
    by_kernel = device_ms_by_kernel(
        lambda: step_fn(state, _train_batch(pipe, TRAIN_STEPS, dev)))
    busy = sum(by_kernel.values())
    ours = {name: sum(t for k, t in by_kernel.items() if pat in k)
            for name, pat in (("B4", "flash_attention_fwd_"),
                              ("B5", "flash_attention_dq_"),
                              ("B6", "flash_attention_dkv_"))}
    gemm = sum(t for k, t in by_kernel.items()
               if any(g in k.lower() for g in ("nvjet", "gemm", "xmma",
                                               "cutlass")))
    rest = busy - sum(ours.values()) - gemm
    log(f"  one step under the profiler: device busy {busy:.2f} ms, "
        f"{100 * busy / step_ms:.1f} % of the median step; "
        + ", ".join(f"{k} {t:.2f} ms ({100 * t / max(busy, 1e-9):.1f} %)"
                    for k, t in ours.items())
        + f", GEMMs {gemm:.2f} ms, everything else {rest:.2f} ms over "
        f"{len(by_kernel)} kernel names")
    for name, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {t:9.3f} ms  {name[:90]}")
    out = dict(step_ms=step_ms, tokens_per_s=tok_s, peak_gb=peaks[-1],
               first_step_peak_gb=peaks[0], state_gb=state_gb,
               n_params=n_params, launches=launches, losses=losses,
               first_batch_after=again,
               busy_share=busy / step_ms, device_ms=ours, gemm_ms=gemm,
               batch=[B, S], layers=cfg.n_layers)
    if arch in SAVE_ATTN_TRAINED:
        out["save_attn"] = _save_attn_reading(dev, cfg, opt, state, pipe)
    del state, step_fn, metrics
    torch.cuda.empty_cache()
    if cfg.n_experts:
        out["moe_backward"] = _moe_backward_reading(dev, cfg)

    # float32 at full width, depth cut: kernels vs plain, and the control
    cfg32 = cfg.with_(dtype="float32", n_layers=FAMILY_GRAD_DEPTH[arch])
    model = T.init_params(cfg32, torch.Generator(device=dev)
                          .manual_seed(SEED))
    batch = _train_batch(TokenPipeline(cfg32, global_batch=GRAD_B,
                                       seq_len=FAMILY_GRAD_SEQ.get(
                                           arch, GRAD_S), seed=SEED), 0, dev)
    l_kern, g_kern = _grads_of(model, cfg32, batch, None)
    l_plain, g_plain = _grads_of(model, cfg32, batch, False)
    err, worst = _leaf_err(g_kern, g_plain)
    del g_kern
    with _patched_backward(_dq_rounded(_attention_layers(cfg32),
                                       GRAD_CONTROL_BITS)):
        _, g_ctrl = _grads_of(model, cfg32, batch, False)
    ctrl, ctrl_worst = _leaf_err(g_ctrl, g_plain)
    loss_err = abs(l_kern - l_plain) / abs(l_plain)
    log(f"  float32 at full width and {cfg32.n_layers} layers, a "
        f"{GRAD_B}x{batch['targets'].shape[1]}-position step, kernels vs "
        f"plain: loss {l_kern:.6f} vs {l_plain:.6f} ({loss_err:.3g} "
        f"relative), worst gradient leaf {err:.3g} of its largest value "
        f"({worst}); control (layer 0's dQ at {GRAD_CONTROL_BITS} mantissa "
        f"bits) {ctrl:.3g} ({ctrl_worst}); limit {GRAD_TOL}")
    check(loss_err <= GRAD_TOL, f"{arch} float32 loss kernels vs plain "
          f"{loss_err}")
    check(err <= GRAD_TOL, f"{arch} float32 gradients kernels vs plain "
          f"{err}")
    check(ctrl > GRAD_TOL, f"{arch} gradient control {ctrl} within "
          f"{GRAD_TOL}")
    del model, g_plain, g_ctrl, batch
    torch.cuda.empty_cache()
    out.update(grad_err=err, grad_worst=worst, grad_control=ctrl)
    return out


def _moe_backward_reading(dev, cfg) -> dict:
    """Layer 0's MoE (moe_local) at full width on MOE_BWD_TOKENS tokens
    (capacity from the capacity factor), on the card: two bf16 backward
    calls bit-equal (the backward of the token gathers adds up to top_k
    contributions into each token's row in an order the device chooses),
    and the float32 gradients within GRAD_TOL of each leaf's largest
    |value| against float64 (the same routing: the router runs in float32
    either way)."""
    import torch

    from repro_torch.models import layers as L

    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = L.init_moe(cfg, gen, torch.float32)
    T = MOE_BWD_TOKENS
    x = _randn((T, cfg.d_model), torch.float32, gen)
    dy = _randn((T, cfg.d_model), torch.float32, gen)
    cap = L.moe_capacity(T, cfg)
    names = ("router", "w_gate", "w_up", "w_down")

    def grads(dt):
        p = L.MoE(base.router.detach().clone(),
                  *(getattr(base, n).detach().to(dt) for n in names[1:]))
        xl = x.to(dt, copy=True).requires_grad_()
        L.moe_local(xl, p, cfg, cap).backward(dy.to(dt))
        out = {n: getattr(p, n).grad for n in names}
        out["x"] = xl.grad
        torch.cuda.synchronize()
        return out

    first = grads(torch.bfloat16)
    again = grads(torch.bfloat16)
    differ = [n for n in first if not torch.equal(first[n], again[n])]
    del first, again
    g32 = grads(torch.float32)
    g64 = grads(torch.float64)
    err, worst = _leaf_err({n: g.double() for n, g in g32.items()}, g64)
    del g32, g64, base
    torch.cuda.empty_cache()
    same = "bit-equal" if not differ else f"differ in {differ}"
    log(f"  moe_local backward at full width, {T} tokens (capacity {cap}): "
        f"two bf16 calls {same}; "
        f"float32 gradients vs float64 on the card: worst leaf {err:.3g} of "
        f"its largest value ({worst}); limit {GRAD_TOL}")
    check(not differ, f"{cfg.name}: two bf16 MoE backward calls differ in "
          f"{differ}")
    check(err <= GRAD_TOL, f"{cfg.name}: float32 MoE gradients vs float64 "
          f"{err}")
    return dict(bitwise=not differ, f32_vs_f64=err)


def _save_attn_reading(dev, cfg, opt, state, pipe) -> dict:
    """One bf16 step's gradients under remat_policy "nothing" and
    "save_attn" on the same parameters and batch: bit-equal, B4 twice and
    once an attention layer; then SAVE_ATTN_STEPS train steps under each
    policy in turns, with their step ms and peak memory."""
    import torch

    from repro_torch.training import make_train_step

    from repro_torch.models import transformer as T

    batch = _train_batch(pipe, TRAIN_STEPS + 1, dev)
    fwd = {}
    for policy in ("nothing", "save_attn"):
        c = cfg.with_(remat_policy=policy)
        _reset_launches()
        if policy == "nothing":
            _, grads = _grads_of(state.params, c, batch, None)
        else:
            for p in state.params.parameters():
                p.grad = None
            T.loss_fn(state.params, c, batch).backward()
        fwd[policy] = _launches()
        expect = _per_step(c, policy == "save_attn")
        check(fwd[policy] == expect, f"{cfg.name} {policy}: launches of "
              f"one step {fwd[policy]} != {expect}")
    differ = [n for n, p in state.params.named_parameters()
              if not torch.equal(p.grad, grads[n])]
    check(not differ, f"{cfg.name}: save_attn gradients differ from "
          f"nothing's: {differ[:5]}")
    del grads
    times = {"nothing": [], "save_attn": []}
    peaks = {}
    for policy in ("nothing", "save_attn", "save_attn", "nothing") * (
            SAVE_ATTN_STEPS // 2):
        step_fn = make_train_step(cfg.with_(remat_policy=policy), opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        times[policy].append(1e3 * (time.perf_counter() - t))
        peaks[policy] = max(peaks.get(policy, 0.0),
                            torch.cuda.max_memory_allocated(dev) / 1e9)
    out = {p: dict(step_ms=statistics.median(t), steps_ms=t,
                   peak_gb=peaks[p], launches=fwd[p])
           for p, t in times.items()}
    log(f"  remat_policy save_attn vs nothing on {cfg.name} ({cfg.n_layers} "
        f"layers): one step's gradients bit-equal; B4 "
        f"{fwd['save_attn']['flash_attention']} vs "
        f"{fwd['nothing']['flash_attention']} launches a step; "
        + "; ".join(f"{p}: step ms "
                    + ", ".join(f"{x:.1f}" for x in r["steps_ms"])
                    + f" (median {r['step_ms']:.2f}), peak "
                    f"{r['peak_gb']:.2f} GB" for p, r in out.items()))
    return out


def _tiny_training(dev, arch: str) -> dict:
    """run_training(preset="tiny") on the card: the smoke config, TINY_STEPS
    steps of the launcher's default batch."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import run_training

    from repro_torch.data import TokenPipeline

    cfg = get_smoke_config(arch).with_(remat=True)
    # run_training's default batch and length
    pipe = TokenPipeline(cfg, global_batch=8, seq_len=64, seed=SEED)
    _reset_launches()
    plain = {}
    with _no_plain_attention(plain):
        run = run_training(arch=arch, preset="tiny", steps=TINY_STEPS,
                           seed=SEED, verbose=False, device=dev)
    torch.cuda.synchronize()
    launches = _launches()
    expect = {k: n * TINY_STEPS for k, n in _per_step(cfg).items()}
    log(f"  {cfg.name} (hd {cfg.head_dim}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads, {cfg.n_layers} layers): run_training(preset=\"tiny\") "
        f"{TINY_STEPS} steps, "
        f"{1e3 * statistics.median(run['step_s'][1:]):.1f} ms a step")
    again = _trained_checks(f"{arch} tiny", cfg, run["losses"], launches,
                            expect, plain, run["state"].params,
                            _train_batch(pipe, 0, dev))
    return dict(launches=launches, losses=run["losses"],
                first_batch_after=again)


def phase_family_training(dev) -> dict:
    out = {}
    for arch in FAMILY_TRAINED:
        log(f"phase 21: training {arch}")
        out[arch] = _family_training(dev, arch)
    out["tiny"] = {}
    for arch in TINY_TRAINED:
        out["tiny"][arch] = _tiny_training(dev, arch)
    return out


# ===========================================================================
# phase 18: the live control plane
# ===========================================================================

def _profiled_tick(tmp: Path) -> dict:
    """:func:`profile_child` in a process of its own, its result read back.

    In this script's own process, after phases 1-17 (about 460 s), the
    profile twice lacked B2's one launch that LAUNCHES counted, while the
    same profile after phases 1, 3 and 14 found every launch: a fresh
    process gives the profiler the conditions it had there."""
    sys.stdout.flush()
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]; import "
            f"chip_smoke as c; c.profile_child({str(tmp)!r})")
    proc = subprocess.run([sys.executable, "-c", code], timeout=600)
    check(proc.returncode == 0,
          f"the profiled tick's process exited {proc.returncode}")
    return json.loads((tmp / "profile.json").read_text())


def profile_child(tmp: str) -> None:
    """Phase 3's tick and route and one 10^4-user sweep item, warmed once,
    then under torch.profiler with the obs ring on: each QoS kernel's
    launches in the profile against LAUNCHES, each inside its
    dispatcher's scope, and their device milliseconds by stage; the
    result as JSON in ``<tmp>/profile.json``."""
    import torch

    from repro_torch import obs
    from repro_torch.core import synthetic_instance
    from repro_torch.kernels.qos_matrix import ops
    from repro_torch.obs.torchprof import kernel_launches, profile_trace
    from repro_torch.serving import Router
    from repro_torch.sweeps import SweepSpec, run_sweep
    from repro_torch.workloads import evaluate_sparse

    tmp = Path(tmp)
    dev = torch.device("cuda")
    inst = synthetic_instance(U_MAIN, n_edges=E_MAIN, seed=SEED)
    router = Router(device=dev)
    one = SweepSpec(scenarios=("synthetic",),
                    override_grid=({"n_users": SWEEP_FULL_USERS},),
                    algos=("egp",), seeds=(SWEEP_FULL_SEEDS,))
    _, xs = evaluate_sparse([inst], device=dev)          # warm
    router.route(inst, placement=xs[0])
    run_sweep(one, device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tracer = obs.enable()
    # the launches after each stage split a kernel's device times (a cold
    # sweep chunk runs twice: once more for a warm timing)
    counts = {}
    t0 = time.perf_counter()
    try:
        with profile_trace(tmp / "profile") as path:
            _, xs = evaluate_sparse([inst], device=dev)
            counts["tick"] = dict(ops.LAUNCHES)
            router.route(inst, placement=xs[0])
            counts["route"] = dict(ops.LAUNCHES)
            run_sweep(one, device=dev)
            counts["sweep item"] = dict(ops.LAUNCHES)
    finally:
        obs.disable()
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    spans = {tracer._names[i] for i in tracer.snapshot()["spans"]["name"]}
    check({"kernel.qos_matrix", "kernel.qos_candidates"} <= spans,
          f"profiled tick: obs kernel spans missing from {sorted(spans)}")
    size_mb = os.path.getsize(path) / 2**20
    doc = json.loads(Path(path).read_text())
    log(f"  profiled tick + sweep item: {wall_s:.2f} s with the profiler; "
        f"LAUNCHES {launches}; Chrome trace {size_mb:.1f} MiB, "
        f"{len(doc['traceEvents'])} events")
    names = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "kernel":
            short = e["name"].split("(")[0].split("::")[-1][:48]
            names[short] = names.get(short, 0) + 1
    log(f"  device kernels in the profile: {names}")
    out = {}
    for name, kernel, scope in PROFILED:
        got = kernel_launches(doc, kernel, scope)
        span = kernel_launches(doc, kernel, "kernel." + name)
        n, ms = got["launches"], got["device_ms"]
        check(n == launches[name] > 0,
              f"profile: {kernel} seen {n} times, LAUNCHES {launches[name]}")
        check(got["in_scope"] == n,
              f"profile: {got['in_scope']} of {n} {kernel} launches inside "
              f"{scope}")
        total = sum(ms)
        queued = sorted(got["queued_ms"]) or [float("nan")]
        by_stage, start = {}, 0
        for stage, c in counts.items():
            seg = ms[start:c[name]]
            start = c[name]
            if seg:
                by_stage[stage] = dict(launches=len(seg), ms=sum(seg),
                                       ms_per_launch=sum(seg) / len(seg))
        log(f"  {kernel}: {n} launches in the profile = LAUNCHES, all "
            f"inside {scope}, {span['in_scope']} inside the kernel.{name} "
            f"span; device {total:.4f} ms summed, {total / n:.5f} ms a "
            f"launch; by stage " + ", ".join(
                f"{st} {v['launches']} x {v['ms_per_launch']:.5f} ms"
                for st, v in by_stage.items())
            + f"; device start - host launch min {queued[0]:.3f}, median "
            f"{queued[len(queued) // 2]:.3f} ms")
        out[name] = dict(launches=n, device_ms=total,
                         ms_per_launch=total / n, by_stage=by_stage,
                         in_kernel_span=span["in_scope"])
    # B2 is only launched through qos_candidates_from_instance, B1 on the
    # route through qos_matrix_from_instance (the sweep item calls the
    # dispatcher itself, as the reference's batched path records no span)
    check(out["qos_candidates"]["in_kernel_span"]
          == out["qos_candidates"]["launches"],
          "profile: B2 launched outside the kernel.qos_candidates span")
    check(out["qos_matrix"]["in_kernel_span"] == 1,
          "profile: the route's B1 outside the kernel.qos_matrix span")
    (tmp / "profile.json").write_text(json.dumps(dict(
        kernels=out, wall_s=wall_s, trace_mib=size_mb)))


def _virtual_replay(cfg):
    """A seeded trace through the virtual-clock gateway, in-process."""
    import asyncio

    from repro_torch.gateway import Gateway, GatewayConfig, run_loadgen

    gw = Gateway(GatewayConfig(horizon=cfg, mode="virtual"))

    async def run():
        async def send(line: str) -> None:
            gw.submit_line(line)

        task = asyncio.ensure_future(gw.run())
        await run_loadgen(send, cfg, wall=False)
        return await task

    return asyncio.run(run()), gw


def _gateway_replays(tmp: Path) -> dict:
    """Every scenario x policy at seed 0 through the virtual gateway, the
    stream on to one file: the reference's digests, the file valid whole,
    one gateway frame a tick; its SLOs and a dashboard screen."""
    from repro_torch import obs
    from repro_torch.gateway import result_digest
    from repro_torch.obs.dash import DashState, render
    from repro_torch.obs.slo import DEFAULT_SLOS, evaluate_slos
    from repro_torch.obs.stream import FrameValidator
    from repro_torch.serving.horizon import HorizonConfig
    from repro_torch.workloads import list_scenarios

    path = tmp / "gateway.jsonl"
    n_ticks, n_runs = 0, 0
    t0 = time.perf_counter()
    obs.enable_stream(str(path), source="chip_smoke")
    try:
        for sc in list_scenarios():
            for pol in TICK_POLICIES:
                cfg = HorizonConfig(scenario=sc, policy=pol, seed=0,
                                    **TICK_LOAD)
                res, gw = _virtual_replay(cfg)
                digest = result_digest(res)
                check(digest == TICK_DIGESTS[(sc, pol)],
                      f"gateway {sc}/{pol}: digest {digest} is not the "
                      f"reference's {TICK_DIGESTS[(sc, pol)]}")
                check(gw.counters["gateway.malformed"] == 0
                      and gw.counters["gateway.admitted"] == res.submitted
                      == gw.counters["gateway.requests"],
                      f"gateway {sc}/{pol}: counters {gw.counters}")
                n_ticks += len(res.per_tick)
                n_runs += 1
    finally:
        obs.disable_stream()
    replay_s = time.perf_counter() - t0
    v = FrameValidator(contiguous=True)
    frames = [v.feed_line(line) for line in path.read_text().splitlines()]
    kinds = [f["type"] for f in frames]
    check(kinds[0] == "hello" and kinds[-1] == "bye",
          f"gateway stream ends {kinds[:1]} ... {kinds[-1:]}")
    check(kinds.count("gateway") == n_ticks,
          f"gateway frames {kinds.count('gateway')} for {n_ticks} ticks")
    log(f"  {n_runs} virtual replays, {n_ticks} ticks in {replay_s:.2f} s "
        f"on the host: every digest is TICK_DIGESTS'; stream "
        f"{path.stat().st_size / 2**20:.2f} MiB, {len(frames)} frames "
        f"valid, one gateway frame a tick")
    for r in evaluate_slos(DEFAULT_SLOS, frames=frames):
        log("    " + r.line())
    state = DashState()
    for f in frames:
        state.update(f)
    log(render(state))
    return dict(runs=n_runs, ticks=n_ticks, s=replay_s, frames=len(frames))


def _soak(tmp: Path) -> dict:
    """The wall-clock soak over TCP on 127.0.0.1 with the stream on: it
    must run without an exception, a malformed frame or a dropped
    request; its verdict and its late requests are printed, not gated
    (they judge the host's clock)."""
    from repro_torch import obs
    from repro_torch.gateway import run_soak
    from repro_torch.obs.slo import DEFAULT_SLOS, evaluate_slos
    from repro_torch.obs.stream import read_stream

    path = tmp / "soak.jsonl"
    obs.enable_stream(str(path), source="chip_smoke-soak")
    try:
        report = run_soak(SOAK["scenario"], seed=0, policy=SOAK["policy"],
                          speed=SOAK["speed"],
                          duration_s=SOAK["duration_s"], tcp=True,
                          overrides=dict(TICK_LOAD))
    finally:
        obs.disable_stream()
    log("  " + report.line())
    log("  " + json.dumps(report.to_json()))
    frames = list(read_stream(str(path)))      # raises on a bad frame
    counters = [f for f in frames if f["type"] == "metrics"][-1][
        "payload"]["counters"]
    check(counters["gateway.malformed"] == 0,
          f"soak: {counters['gateway.malformed']} malformed frame(s)")
    # a request that reaches the gateway after its tick's wall deadline is
    # counted late, not admitted (its tick has stepped): like the verdict,
    # that judges the host's clock, so it is printed; what is gated is that
    # nothing is dropped at ingress and nothing is admitted that was not
    # sent
    check(report.ticks > 0 and report.admitted > 0
          and report.dropped_ingress == 0
          and report.admitted + report.late <= report.sent,
          f"soak: {report.admitted} admitted and {report.late} late of "
          f"{report.sent} sent, {report.dropped_ingress} dropped")
    log(f"  soak: {report.admitted} of {report.sent} sent admitted, "
        f"{report.late} late, "
        f"{report.sent - report.admitted - report.late} still queued at "
        f"the last deadline; admitted == sent: "
        f"{report.admitted == report.sent}")
    check(sum(f["type"] == "gateway" for f in frames) == report.ticks,
          "soak: one gateway frame a tick")
    for r in evaluate_slos(DEFAULT_SLOS, frames=frames):
        log("    " + r.line())
    return report.to_json()


def _pareto(dev, store: Path) -> dict:
    """pareto_mask_torch on the card against pareto_mask_np, exactly, and
    frontier_points through both masks over phase 14's serving store."""
    import numpy as np
    import torch

    from repro_torch.tuning import (frontier_points, pareto_mask_np,
                                    pareto_mask_torch)

    n = 0
    for shape in PARETO_SHAPES:
        for seed in PARETO_SEEDS:
            for dtype in (np.float32, np.float64):
                rng = np.random.default_rng(seed)
                pts = np.round(rng.normal(size=shape).astype(dtype), 1)
                maximize = [bool(b) for b in
                            rng.integers(0, 2, size=shape[1])]
                got = pareto_mask_torch(pts, maximize, device=dev)
                check(np.array_equal(got, pareto_mask_np(pts, maximize)),
                      f"pareto {shape} {dtype.__name__} seed {seed}: the "
                      "card's mask differs from NumPy's")
                n += 1
    sub = np.array([[0.5, 1.0], [0.5 + 1e-12, 1.0]])
    check(pareto_mask_torch(sub, (True, False), device=dev).tolist()
          == [False, True], "pareto: float64 below float32 resolution")
    times = {}
    rng = np.random.default_rng(0)
    big = np.round(rng.normal(size=PARETO_SHAPES[-1]), 1)
    for dtype in (np.float32, np.float64):
        pts = big.astype(dtype)
        on_card = torch.from_numpy(pts).to(dev)
        dev_ms = time_ms(lambda: pareto_mask_torch(
            on_card, (True, False, True), device=dev))
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            pareto_mask_np(pts, (True, False, True))
            host.append(1e3 * (time.perf_counter() - t0))
        times[dtype.__name__] = dict(device_ms=dev_ms,
                                     numpy_ms=statistics.median(host))
    via_card = frontier_points(store, use_device=True, device=dev)
    via_np = frontier_points(store)
    check({k: [repr(p) for p in v] for k, v in via_card.items()}
          == {k: [repr(p) for p in v] for k, v in via_np.items()},
          "frontier_points: the card's mask and NumPy's differ")
    n_points = sum(len(v) for v in via_np.values())
    log(f"  pareto_mask_torch == pareto_mask_np on {n} grids up to "
        f"{PARETO_SHAPES[-1]} (float32, float64) and below float32 "
        f"resolution; frontier_points over phase 14's store: {n_points} "
        f"points, the same through both masks; at {PARETO_SHAPES[-1]} "
        f"the card's mask (events, mask back on the host) vs NumPy: "
        f"{times}")
    return dict(grids=n, points=n_points, times=times)


def phase_control_plane(dev, store: Path) -> dict:
    """Phase 18: the profiler over B1-B3, the virtual-clock gateway, the
    wall-clock soak and the Pareto mask on the card."""
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        for key, fn in (("profile", lambda: _profiled_tick(tmp)),
                        ("gateway", lambda: _gateway_replays(tmp)),
                        ("soak", lambda: _soak(tmp)),
                        ("pareto", lambda: _pareto(dev, store))):
            t0 = time.perf_counter()
            out[key] = fn()
            log(f"  ({key}: {time.perf_counter() - t0:.1f} s)")
    return out


# ===========================================================================
# phase 22: the fleet on the card
# ===========================================================================

def _fleet_counts(summary: dict) -> dict:
    """B1's and B3's launches in a stitched fleet trace's counters."""
    counters = summary["counters"]
    return {name: int(counters.get(f"kernel.{name}.launches", 0))
            for name in ("qos_matrix", "greedy_argmax")}


def _fleet_cli(tmp: Path) -> dict:
    """``python -m repro_torch.sweeps --fleet 2 --device cuda --validate``
    twice on one store: the first drains everything through the fleet
    (its final run_sweep computes 0 chunks) within SWEEP_ATOL of the host
    path, the second plans 0 tasks."""
    cmd = [sys.executable, "-m", "repro_torch.sweeps", "--scenario",
           FLEET_CLI_SCENARIOS, "--seeds", FLEET_CLI_SEEDS, "--device",
           "cuda", "--validate", "--fleet", "2", "--out", str(tmp / "cli")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    outs = []
    for call in (1, 2):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        text = proc.stdout + proc.stderr
        check(proc.returncode == 0, f"sweep CLI --fleet 2 call {call} exit "
              f"{proc.returncode}:\n{text[-3000:]}")
        planned = re.search(r"\[fleet\] planned (\d+) task", text)
        computed = re.search(r"\[sweeps\] (\d+) chunk\(s\) computed", text)
        valid = re.search(r"max\|Δσ\| = (\S+) <=", text)
        check(planned is not None and computed is not None
              and valid is not None, f"sweep CLI output:\n{text[-3000:]}")
        outs.append(dict(wall_s=wall, planned=int(planned.group(1)),
                         computed=int(computed.group(1)),
                         max_diff=float(valid.group(1))))
    first, second = outs
    log(f"  sweep CLI --fleet 2 --validate ({FLEET_CLI_SCENARIOS}, seeds "
        f"{FLEET_CLI_SEEDS}): planned {first['planned']} task(s), its "
        f"final run_sweep computed {first['computed']} chunk(s), max "
        f"|accel - host| {first['max_diff']:.3g}, {first['wall_s']:.1f} s; "
        f"again: planned {second['planned']}, {second['wall_s']:.1f} s")
    check(first["planned"] > 0 and first["computed"] == 0,
          f"the CLI's fleet left work to its safety net: {first}")
    check(first["max_diff"] <= SWEEP_ATOL, f"CLI validation {first}")
    check(second["planned"] == 0 and second["computed"] == 0,
          f"the second CLI call planned work: {second}")
    return dict(first=first, second=second)


def phase_fleet(dev) -> dict:
    """repro_torch.fleet on the card: one process against FLEET_WORKERS
    worker processes (CUDA contexts sharing the card) on the same sweep,
    one SIGKILLed holding a lease, reaped, mopped up and merged bit-equal;
    the workers' B1/B3 launches from their stitched obs artifacts; then
    the sweep CLI's --fleet."""
    import signal

    import torch

    from repro_torch.fleet import (LeaseQueue, merge, plan, reap,
                                   run_worker, spawn_local_workers, status)
    from repro_torch.fleet.telemetry import read_telemetry
    from repro_torch.kernels.qos_matrix import ops
    from repro_torch.obs import stitch_fleet
    from repro_torch.sweeps import SweepSpec, run_sweep
    from repro_torch.sweeps.shard import DEFAULT_MEMORY_BUDGET_MB

    spec = SweepSpec(scenarios=("synthetic",),
                     override_grid=({"n_users": SWEEP_FULL_USERS},),
                     algos=("egp", "agp"), seeds=range(FLEET_SEEDS))
    n_items = len(spec.expand())
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    procs = []
    saved_env = {k: os.environ.get(k) for k in ("REPRO_OBS",
                                                 "REPRO_OBS_DIR")}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = run_sweep(spec, tmp / "one", device=dev)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        check(one.complete, "single-process sweep incomplete")

        root = tmp / "fleet"
        pl = plan(spec, root)
        check(pl["n_tasks"] == n_items and pl["n_items"] == n_items,
              f"fleet plan {pl}")
        free_mb = torch.cuda.mem_get_info(dev)[0] / 2**20
        budget = min(DEFAULT_MEMORY_BUDGET_MB,
                     free_mb / (2 * FLEET_WORKERS))
        os.environ.update(REPRO_OBS="1", REPRO_OBS_DIR=str(root / "obs"))
        t0 = time.perf_counter()
        procs = spawn_local_workers(root, FLEET_WORKERS, ttl=FLEET_TTL_S,
                                    memory_budget_mb=budget, device="cuda")
        queue = LeaseQueue(root / "queue")
        deadline = time.time() + 300
        owner = held = None
        while owner is None and time.time() < deadline:
            for name in queue.leased():
                try:       # a lease may complete, or lack its block yet
                    doc = json.loads((queue.lease_dir / f"{name}.json")
                                     .read_text())
                except (OSError, ValueError):
                    continue
                owner = doc.get("lease", {}).get("owner")
                if owner is not None:
                    held = name
                    break
            else:
                time.sleep(0.02)
        check(owner is not None and owner.startswith("local-"),
              f"no fleet worker held a lease in 300 s (owner {owner!r})")
        victim = procs[int(owner.split("-")[1])]
        victim.send_signal(signal.SIGKILL)
        victim.wait()
        rcs = {i: p.wait(timeout=600) for i, p in enumerate(procs)
               if p is not victim}
        workers_s = time.perf_counter() - t0
        check(all(rc == 0 for rc in rcs.values()),
              f"surviving fleet workers' exit codes {rcs}")
        deadline = time.time() + 4 * FLEET_TTL_S
        while queue.leased() and time.time() < deadline:
            time.sleep(0.2)
            reap(root)
        check(not queue.leased(), f"leases never expired: {queue.leased()}")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        mop = run_worker(root, owner="mopup", ttl=FLEET_TTL_S, device="cuda")
        torch.cuda.synchronize()
        mop_launches = {k: ops.LAUNCHES[k]
                        for k in ("qos_matrix", "greedy_argmax")}
        fleet_s = time.perf_counter() - t0
        st = status(root)
        check(st["queue"]["pending"] == 0 and st["queue"]["leased"] == 0
              and st["queue"]["done"] == n_items, f"fleet queue {st['queue']}")
        mg = merge(root, tmp / "merged")
        check(mg["missing_items"] == 0 and mg["target_items"] == n_items,
              f"fleet merge {mg}")
        again = run_sweep(spec, tmp / "merged", device=dev)
        check(again.execution["chunks_computed"] == 0,
              f"run_sweep on the merged store computed "
              f"{again.execution['chunks_computed']} chunk(s)")
        check(_same_values(one, again),
              "fleet values differ from the single-process run's bytes")
        stitched = stitch_fleet(root)
        worker_launches = _fleet_counts(stitched)
        check(stitched["n_artifacts"] == FLEET_WORKERS - 1,
              f"{stitched['n_artifacts']} worker obs artifacts, expected "
              f"{FLEET_WORKERS - 1} (the killed worker saves none)")
        check(all(n > 0 for n in worker_launches.values()),
              f"surviving workers' B1/B3 launches {worker_launches}")
        launches = {k: worker_launches[k] + mop_launches[k]
                    for k in worker_launches}
        tele = read_telemetry(root)["workers"]
        rates = {o: r.get("items_per_s") for o, r in sorted(tele.items())}
        log(f"  one process: {n_items} items (10^4 users, egp/agp, "
            f"{FLEET_SEEDS} seeds) in {one_s:.2f} s, "
            f"{n_items / one_s:.3f} items/s")
        log(f"  fleet: {FLEET_WORKERS} workers (budget {budget:.0f} MB "
            f"each, ttl {FLEET_TTL_S} s), {owner} SIGKILLed holding "
            f"{held}; workers exited after {workers_s:.2f} s, reap + "
            f"mop-up ({mop['n_tasks']} task(s)) done at {fleet_s:.2f} s: "
            f"{n_items / fleet_s:.3f} items/s end to end; merged "
            f"{mg['merged_items']} item(s), {mg['duplicate_items']} "
            "duplicate(s) verified, values bit-equal to one process")
        log(f"  telemetry items/s by worker: {rates}")
        log(f"  B1/B3 launches: surviving workers {worker_launches} (from "
            f"{stitched['n_artifacts']} stitched obs artifacts, "
            f"{stitched['n_events']} events), mop-up {mop_launches}")
        cli = _fleet_cli(tmp)
        return dict(one_s=one_s, fleet_s=fleet_s, workers_s=workers_s,
                    items=n_items, rates=rates, launches=launches,
                    worker_launches=worker_launches,
                    mop_launches=mop_launches, cli=cli)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


# ===========================================================================
# phase 23: the int8 implementation variants
# ===========================================================================

def _quantized_equal(a, sa, b, sb) -> bool:
    """Two quantize_tree results equal bit for bit (values and scales)."""
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    return pa.keys() == pb.keys() and all(
        _same_tensor(pa[n], pb[n]) and (sa[n] is None) == (sb[n] is None)
        and (sa[n] is None or _same_tensor(sa[n], sb[n])) for n in pa)


def _same_tensor(x, y) -> bool:
    import torch

    return x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


def phase_quant(dev) -> dict:
    """The int8 variants of smollm-360m and mamba2-2.7b at full width and
    depth: quantize_tree on the card (smollm bit-equal to the CPU), the
    storage against QUANT_BYTES and bf16, and the top-1 agreement of the
    dequantized model through B4 (smollm) or B8 (mamba2), with controls."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.quant import (dequantize_tree, logit_agreement,
                                          quantize_tree, quantized_bytes)

    out = {}
    for arch, kernel in (("smollm_360m", "flash_attention"),
                         ("mamba2_2p7b", "ssd_scan")):
        cfg = get_config(arch)
        model = T.init_params(cfg, torch.Generator(device=dev)
                              .manual_seed(SEED))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, s = quantize_tree(model)
        torch.cuda.synchronize()
        quant_ms = 1e3 * (time.perf_counter() - t0)
        qb = quantized_bytes(q, s)
        bf16_b = sum(p.numel() * 2 for p in model.parameters())
        check(qb == QUANT_BYTES[arch],
              f"{arch} quantized_bytes {qb} != {QUANT_BYTES[arch]}")
        n_q = sum(v is not None for v in s.values())
        line = (f"  {arch}: quantize_tree on the card {quant_ms:.1f} ms, "
                f"{n_q} of {len(s)} parameters int8; quantized_bytes {qb} "
                f"(= QUANT_BYTES) against {bf16_b} bf16 bytes: ratio "
                f"{qb / bf16_b:.4f} (catalog storage_ratio 0.52)")
        if arch == "smollm_360m":
            t0 = time.perf_counter()
            qc, sc = quantize_tree(_cpu_copy(model))
            cpu_s = time.perf_counter() - t0
            check(_quantized_equal(q, s, qc, sc),
                  f"{arch}: quantize_tree on the card != on the CPU")
            line += (f"; int8 values and scales bit-equal to the CPU's "
                     f"({cpu_s:.1f} s there)")
            del qc, sc
        log(line)
        deq = dequantize_tree(q, s)
        del q, s
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        agree = logit_agreement(cfg, model, deq, n_probes=QUANT_PROBES,
                                seq=QUANT_SEQ, seed=SEED)
        torch.cuda.synchronize()
        agree_s = time.perf_counter() - t0
        launches = _launches()
        expect = 2 * cfg.n_layers
        check(launches[kernel] == expect,
              f"{arch} logit_agreement {kernel} launches {launches} "
              f"(expected {expect})")
        self_agree = logit_agreement(cfg, model, model,
                                     n_probes=QUANT_PROBES, seq=QUANT_SEQ,
                                     seed=SEED)
        del deq
        other = T.init_params(cfg, torch.Generator(device=dev)
                              .manual_seed(SEED + 1))
        other_agree = logit_agreement(cfg, model, other,
                                      n_probes=QUANT_PROBES, seq=QUANT_SEQ,
                                      seed=SEED)
        del other, model
        torch.cuda.empty_cache()
        log(f"    top-1 agreement of the int8 variant (dequantized to "
            f"bf16) over {QUANT_PROBES} x {QUANT_SEQ} probe tokens: "
            f"{agree:.6f} ({agree_s:.2f} s; {kernel} launches "
            f"{launches[kernel]} = 2 forwards x {cfg.n_layers} layers); "
            f"controls: the model against itself {self_agree:.6f}, against "
            f"seed {SEED + 1}'s {other_agree:.6f} (chance "
            f"{1 / cfg.vocab_size:.2g})")
        check(self_agree == 1.0, f"{arch} self-agreement {self_agree}")
        check(other_agree <= 0.01, f"{arch} another seed's agreement "
              f"{other_agree} is not near chance")
        check(other_agree < agree <= 1.0,
              f"{arch} int8 agreement {agree} (control {other_agree})")
        out[arch] = dict(bytes=qb, bf16_bytes=bf16_b, ratio=qb / bf16_b,
                         agreement=agree, self=self_agree,
                         other_seed=other_agree, quant_ms=quant_ms,
                         launches={kernel: launches[kernel]})
    return out


def _cpu_copy(model):
    """``model``'s parameters copied to the CPU (the card's stay)."""
    import copy

    return copy.deepcopy(model).cpu()


# ===========================================================================
# phase 24: compressed training
# ===========================================================================

def _transform_check(dev, cfg, run: dict, pipe, method: str) -> dict:
    """The next step's gradients and the run's carry through
    ErrorFeedback on the card against the same transform on the CPU (topk
    bit for bit, int8 with the card's draws), and the new carry equal to
    corrected - kept exactly."""
    import torch

    from repro_torch.convert import reference_leaves
    from repro_torch.distributed import ErrorFeedback
    from repro_torch.training import AdamWConfig
    from repro_torch.training.trainer import make_grad_and_apply

    grad_fn, _ = make_grad_and_apply(cfg, AdamWConfig(lr=TRAIN_LR))
    model, carry = run["state"].params, run["carry"]
    _, grads = grad_fn(model, _train_batch(pipe, TRAIN_STEPS, dev))
    grads = {n: g.detach().clone() for n, g in grads.items()}
    leaves = reference_leaves(model)
    ef = ErrorFeedback(method=method, leaves=leaves)
    drawn = {}

    def record(i, leaf):
        drawn[i] = ef.draws(i, leaf)
        return drawn[i]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, new = ef.transform(grads, carry, uniform=record)
    torch.cuda.synchronize()
    card_ms = 1e3 * (time.perf_counter() - t0)
    for leaf in leaves:
        def stack(d):
            parts = [d[n] for n in leaf.names]
            return torch.stack(parts) if leaf.stacked else parts[0]
        corrected = stack({n: grads[n].float() + carry[n]
                           for n in leaf.names})
        check(torch.equal(stack(new), corrected - stack(out)),
              f"{method}: carry != corrected - kept at {leaf.path}")
    kept = sum(int((o != 0).sum()) for o in out.values())
    total = sum(o.numel() for o in out.values())
    cpu = lambda d: {n: t.cpu() for n, t in d.items()}  # noqa: E731
    t0 = time.perf_counter()
    out_c, new_c = ef.transform(cpu(grads), cpu(carry),
                                uniform=lambda i, leaf: drawn[i].cpu())
    cpu_s = time.perf_counter() - t0
    for n in grads:
        check(torch.equal(out[n].cpu(), out_c[n])
              and torch.equal(new[n].cpu(), new_c[n]),
              f"{method}: the card's transform != the CPU's at {n}")
    log(f"    {method}: one step's transform on the card {card_ms:.1f} ms "
        f"({kept} of {total} gradient entries nonzero), the carry equal "
        f"to corrected - kept at every leaf, and bit-equal to the same "
        f"transform on the CPU ({cpu_s:.1f} s there"
        + (", the card's draws" if method == "int8" else "") + ")")
    return dict(card_ms=card_ms, cpu_s=cpu_s, kept=kept, total=total)


def phase_compressed_training(dev, trained: dict) -> dict:
    """run_training(compression=...) of smollm-360m at full width and
    depth at phase 12's shape: finite losses, phase 12's B4/B5/B6 launches
    a step, the step time beside phase 12's, the carry's bytes, the peak
    memory, and the transform on the card against the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import run_training

    cfg = get_config("smollm_360m").with_(remat=True)
    expect = {k: n * TRAIN_STEPS for k, n in _per_step(cfg).items()}
    check(expect == trained["launches"], f"phase 12 launches "
          f"{trained['launches']} != {expect}")
    pipe = TokenPipeline(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S,
                         seed=SEED)
    out = {}
    for method in COMPRESSIONS:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        _reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        run = run_training(arch="smollm_360m", preset="full",
                           steps=TRAIN_STEPS, global_batch=TRAIN_B,
                           seq_len=TRAIN_S, seed=SEED, lr=TRAIN_LR,
                           compression=method, verbose=False, device=dev)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        launches = _launches()
        losses = run["losses"]
        check(len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all()),
              f"{method}: losses {losses}")
        check(launches == trained["launches"],
              f"{method}: launches {launches} != phase 12's "
              f"{trained['launches']}")
        step_ms = 1e3 * statistics.median(run["step_s"][1:])
        carry_b = sum(c.numel() * c.element_size()
                      for c in run["carry"].values())
        log(f"  {method}: losses {', '.join(f'{x:.4f}' for x in losses)}; "
            f"launches {launches} (phase 12's); step ms "
            f"{', '.join(f'{1e3 * s:.1f}' for s in run['step_s'])}, median "
            f"of steps 2-{TRAIN_STEPS} {step_ms:.2f} ms against phase 12's "
            f"uncompressed {trained['step_ms']:.2f} ms "
            f"({step_ms / trained['step_ms']:.2f}x); carry {carry_b} bytes; "
            f"peak device memory {peak_gb:.2f} GB (phase 12: "
            f"{trained['peak_gb']:.2f} GB)")
        check_out = _transform_check(dev, cfg, run, pipe, method)
        out[method] = dict(losses=losses, launches=launches,
                           step_ms=step_ms, carry_bytes=carry_b,
                           peak_gb=peak_gb, **check_out)
        del run
    torch.cuda.empty_cache()
    return out


def _mesh_grads(dev, cfg, ctx) -> dict:
    """One float32 gradient of ``cfg`` at GRAD_B x GRAD_S (the rows
    rounded up to a multiple of the data axis) without a mesh and on
    ``ctx``'s mesh with sp_matmuls off and, where the heads and d_ff split
    over the model axis (the reference's shard_map raises otherwise), on:
    the loss and leaf errors, B4-B6 launches and collective counts of
    each. Without the mesh the rows go as one microbatch a data rank
    (grad_accum): the mesh's MoE routes each data rank's tokens with their
    own capacity, as the reference's does, and the mean of the
    microbatches' losses is the mesh's loss where every row holds as many
    tokens."""
    import dataclasses

    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import collectives as C
    from repro_torch.models import transformer as T
    from repro_torch.training.trainer import _grads

    cfg32 = cfg.with_(dtype="float32")
    model = T.init_params(cfg32, torch.Generator(device=dev)
                          .manual_seed(SEED))
    rows = -(-GRAD_B // ctx.data_size) * ctx.data_size
    pipe = TokenPipeline(cfg32, global_batch=rows, seq_len=GRAD_S, seed=SEED)
    batch = _train_batch(pipe, 0, dev)
    _reset_launches()
    loss0, g = _grads(model, cfg32, batch, ctx.data_size)
    want = {n: t.detach().clone() for n, t in g.items()}
    launches0 = {k: n // ctx.data_size for k, n in _launches().items()}
    out = {"launches": launches0, "rows": rows, "layers": cfg.n_layers}
    m = ctx.model_size
    sizes = (cfg.ssm_heads,) if cfg.family == "ssm" else (
        cfg.gqa.n_q_pad, cfg.gqa.n_kv_pad, cfg.d_ff_pad)
    splits = all(n % m == 0 for n in sizes)
    for sp in (False, True) if splits else (False,):
        _reset_launches()
        C.reset_counts()
        blocks, bctx = _mesh_batch(pipe, 0, dev, dataclasses.replace(
            ctx, sp_matmuls=sp))
        loss, g = _grads(model, cfg32, blocks, 1, bctx)
        launches = _launches()
        err, worst = _leaf_err(g, want)
        loss_err = abs(float(loss) - float(loss0)) / abs(float(loss0))
        counts = {op: dict(c) for op, c in C.COUNTS.items()}
        check(loss_err <= GRAD_TOL and err <= GRAD_TOL,
              f"{cfg.name} sp={sp}: mesh loss {float(loss)} vs "
              f"{float(loss0)}, worst leaf {err} ({worst})")
        check(launches == launches0, f"{cfg.name} sp={sp}: mesh launches "
              f"{launches} != the no-mesh step's {launches0}")
        # a baseline on a one-rank model axis has no sequence to gather;
        # SP gathers it and the FSDP shard inside its projections
        check(counts["psum"]["calls"] > 0 and (not sp or (
            counts["all_gather"]["calls"] > 0
            and counts["psum_scatter"]["calls"] > 0)),
            f"{cfg.name} sp={sp}: collectives {counts}")
        out[f"sp{int(sp)}"] = dict(loss_err=loss_err, grad_err=err,
                                   worst=worst, counts=counts)
    del model, want, g
    torch.cuda.empty_cache()
    return out


def _mesh_steps(dev, cfg, mesh, arch: str, depth, sp: bool):
    """MESH_STEPS bf16 steps of TRAIN_B x TRAIN_S tokens from one seed
    without and with the mesh: a model at full depth through run_training,
    a cut one through make_train_step (with ``sp`` as sp_matmuls); without
    the mesh one microbatch a data rank, as :func:`_mesh_grads` says;
    each step's ms, ended by reading the loss on the host. Returns the
    runs and the gates they fail (the losses within MESH_FIRST_TOL and
    MESH_STEP_TOL of one device's, the launches equal)."""
    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import run_training
    from repro_torch.models.layers import MeshContext
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    data = int(mesh.shape[0])
    runs = {}
    for on in (False, True):
        torch.cuda.empty_cache()
        _reset_launches()
        accum = 1 if on else data
        if depth is None:
            run = run_training(arch=arch, preset="full", steps=MESH_STEPS,
                               global_batch=TRAIN_B, seq_len=TRAIN_S,
                               seed=SEED, lr=TRAIN_LR, verbose=False,
                               grad_accum=accum,
                               mesh=mesh if on else None, device=dev)
            losses, step_s = run["losses"], run["step_s"]
            del run
        else:
            opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=10)
            ctx = MeshContext(mesh, ("data",), sp_matmuls=sp) if on \
                else None
            state = init_train_state(cfg, opt, torch.Generator(device=dev)
                                     .manual_seed(SEED))
            pipe = TokenPipeline(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S,
                                 seed=SEED)
            batches = [_mesh_batch(pipe, i, dev, ctx) if on else
                       (_train_batch(pipe, i, dev), None)
                       for i in range(MESH_STEPS)]
            step_fn = make_train_step(cfg, opt, batches[0][1],
                                      grad_accum=accum)
            losses, step_s = [], []
            for step in range(MESH_STEPS):
                t = time.perf_counter()
                state, metrics = step_fn(state, batches[step][0])
                losses.append(float(metrics["loss"]))
                step_s.append(time.perf_counter() - t)
            del state, step_fn, metrics, batches
        runs["mesh" if on else "one"] = dict(
            losses=losses, step_ms=[1e3 * x for x in step_s],
            launches={k: n // accum for k, n in _launches().items()})
    one, on = runs["one"], runs["mesh"]
    first = abs(on["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
    worst = max(abs(a - b) / abs(b) for a, b in zip(on["losses"],
                                                    one["losses"]))
    failed = [what for ok, what in (
        (first <= MESH_FIRST_TOL and worst <= MESH_STEP_TOL,
         f"{arch} mesh losses {on['losses']} vs {one['losses']} (first "
         f"{first:.3g} of {MESH_FIRST_TOL}, worst {worst:.3g} of "
         f"{MESH_STEP_TOL})"),
        (on["launches"] == one["launches"], f"{arch} mesh step launches "
         f"{on['launches']} != {one['launches']}")) if not ok]
    torch.cuda.empty_cache()
    return runs, failed


def _mesh_sharded(dev, cfg, ctx, arch: str, tmp: str) -> dict:
    """MESH_STEPS bf16 TRAIN_B x TRAIN_S steps of make_train_step on the
    mesh with the state stored as this rank's blocks, then with the
    replicated state from the same seed (each run's peak counted above
    what the card holds besides its own state, by step up to the
    optimizer and in it; the sharded state's gradients freed before the
    replicated run): losses, step ms, launches, bytes of state and peak
    GB of each, every block bit-equal
    to the same block of the replicated state after the steps; for
    MESH_CKPT a checkpoint of the sharded state saved and restored with
    mesh=/pspecs= into another sharded state,
    bit-equal, with its seconds."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.data import TokenPipeline
    from repro_torch.models.layers import block_of
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step, param_tree,
                                      shard_train_state, state_bytes,
                                      train_state_pspecs)

    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=10)
    pipe = TokenPipeline(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S,
                         seed=SEED)
    batches = [_mesh_batch(pipe, i, dev, ctx) for i in range(MESH_STEPS)]
    step = make_train_step(cfg, opt, batches[0][1])

    def init():
        return init_train_state(cfg, opt, torch.Generator(device=dev)
                                .manual_seed(SEED))

    cuda = dev.type == "cuda"       # tools/mesh_phase.py --cpu: no card

    def run(state):
        # each step's peaks above what the card holds besides this state:
        # up to the optimizer (forward, backward, the replicated state's
        # reduction) and the optimizer's own (trainer._apply), so that the
        # two layouts' peaks can be told apart by phase
        from repro_torch.training import trainer

        base, grads_gb, update_gb = 0, [], []
        apply = trainer._apply

        def split_apply(*a, **k):
            grads_gb.append((torch.cuda.max_memory_allocated(dev) - base)
                            / 1e9)
            torch.cuda.reset_peak_memory_stats(dev)
            return apply(*a, **k)

        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev) - state_bytes(state)
            trainer._apply = split_apply
        _reset_launches()
        losses, ms = [], []
        try:
            for i in range(MESH_STEPS):
                t = time.perf_counter()
                state, metrics = step(state, batches[i][0])
                losses.append(float(metrics["loss"]))
                ms.append(1e3 * (time.perf_counter() - t))
                if cuda:
                    update_gb.append((torch.cuda.max_memory_allocated(dev)
                                      - base) / 1e9)
                    torch.cuda.reset_peak_memory_stats(dev)
        finally:
            trainer._apply = apply
        return state, dict(losses=losses, step_ms=ms, launches=_launches(),
                           state_bytes=state_bytes(state),
                           peak_gb=max(grads_gb + update_gb, default=0.0),
                           grads_peak_gb=grads_gb, update_peak_gb=update_gb)

    whole = init()
    sharded = shard_train_state(whole, cfg, ctx)
    del whole
    sharded, out_s = run(sharded)
    for p in sharded.params.parameters():   # the same baseline for both
        p.grad = None
    whole, out_r = run(init())
    check(out_s["losses"] == out_r["losses"], f"{arch} sharded state's "
          f"losses {out_s['losses']} != the replicated state's "
          f"{out_r['losses']}")
    check(out_s["launches"] == out_r["launches"], f"{arch} sharded state's "
          f"launches {out_s['launches']} != {out_r['launches']}")
    worst, where = 0.0, ""
    full = {**{f"params/{n}": p.detach() for n, p in
               param_tree(whole.params).items()},
            **{f"m/{n}": t for n, t in whole.opt.m.items()},
            **{f"v/{n}": t for n, t in whole.opt.v.items()}}
    specs = {n: p.pspec for n, p in param_tree(sharded.params).items()}
    mine = {**{f"params/{n}": p.detach() for n, p in
               param_tree(sharded.params).items()},
            **{f"m/{n}": t for n, t in sharded.opt.m.items()},
            **{f"v/{n}": t for n, t in sharded.opt.v.items()}}
    for key, got in mine.items():
        want = block_of(full[key], specs[key.split("/", 1)[1]], ctx)
        e = 0.0 if torch.equal(got, want) else float(
            (got - want).abs().max()) / max(float(full[key].abs().max()),
                                            1e-30)
        if e > worst:
            worst, where = e, key
    check(worst == 0.0, f"{arch} sharded state after {MESH_STEPS} steps: "
          f"block {where} {worst} of its leaf's largest |value| off the "
          "replicated state's")
    out = dict(sharded=out_s, replicated=out_r, worst=worst, worst_leaf=where)
    del whole, full
    if arch == MESH_CKPT:
        pspecs = train_state_pspecs(cfg)
        path = os.path.join(tmp, "sharded_ckpt")
        t = time.perf_counter()
        save_checkpoint(path, MESH_STEPS, sharded, mesh=ctx.mesh,
                        pspecs=pspecs)
        dist.barrier()
        save_s = time.perf_counter() - t
        like = shard_train_state(init_train_state(
            cfg, opt, torch.Generator(device=dev).manual_seed(SEED + 1)),
            cfg, ctx)
        t = time.perf_counter()
        back = restore_checkpoint(path, MESH_STEPS, like, mesh=ctx.mesh,
                                  pspecs=pspecs)
        restore_s = time.perf_counter() - t
        same = int(back.opt.step) == MESH_STEPS and all(
            torch.equal(a.detach(), b.detach()) for a, b in zip(
                [*param_tree(back.params).values(), *back.opt.m.values(),
                 *back.opt.v.values()],
                [*param_tree(sharded.params).values(),
                 *sharded.opt.m.values(), *sharded.opt.v.values()]))
        check(same, f"{arch}: the sharded checkpoint restored with mesh=/"
              "pspecs= differs from the state saved")
        out["checkpoint"] = dict(save_s=save_s, restore_s=restore_s,
                                 bytes=sum(f.stat().st_size for f in
                                           Path(path).rglob("*.npy")))
        del like, back
    del sharded
    torch.cuda.empty_cache()
    return out


def _mesh_profile(dev, cfg, mesh) -> dict:
    """One bf16 TRAIN_B x TRAIN_S make_train_step step without and with
    the mesh (after a warm-up step): its wall ms, then under
    torch.profiler its device busy ms, the NCCL kernels' share, and the
    largest host operations of the mesh step."""
    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.models.layers import MeshContext
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=10)
    pipe = TokenPipeline(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S,
                         seed=SEED)
    out = {}
    for on in (False, True):
        torch.cuda.empty_cache()
        state = init_train_state(cfg, opt, torch.Generator(device=dev)
                                 .manual_seed(SEED))
        batch, ctx = _mesh_batch(pipe, 0, dev, MeshContext(
            mesh, ("data",))) if on else (_train_batch(pipe, 0, dev), None)
        step_fn = make_train_step(cfg, opt, ctx,
                                  grad_accum=1 if on else int(mesh.shape[0]))
        step_fn(state, batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        float(step_fn(state, batch)[1]["loss"])
        wall = 1e3 * (time.perf_counter() - t)
        by_kernel = device_ms_by_kernel(lambda: step_fn(state, batch))
        reading = dict(wall_ms=wall, busy_ms=sum(by_kernel.values()),
                       nccl_ms=sum(v for k, v in by_kernel.items()
                                   if "nccl" in k.lower()))
        if on:
            reading["host_ops"] = _host_ms_by_op(
                lambda: step_fn(state, batch))
        out["mesh" if on else "one"] = reading
        del state, step_fn
    torch.cuda.empty_cache()
    return out


def mesh_rank(rank: int, world: int, init_file: str, out_dir: str,
              model: int = 1, device: str = "cuda",
              profile: bool = False) -> None:
    """Phase 25 in one rank (a spawned process on card ``rank``): the
    NCCL process group, make_host_mesh(model=model), every model's
    gradients and steps with and without it (with ``profile``, the full
    depth models' profiled steps too: about 35 s more), and
    compressed_psum against the CPU; writes its readings to
    ``out_dir/rank<r>.json``. ``device="cpu"`` rehearses it with gloo."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import compressed_psum, int8_round
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import MeshContext

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device(device)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        mesh = make_host_mesh(model=model, device=device)
        ctx = MeshContext(mesh, ("data",))
        out = {"world": world, "mesh": dict(zip(mesh.mesh_dim_names,
                                                tuple(mesh.shape))),
               "models": {}}
        for arch, depth in MESH_MODELS:
            t0 = time.perf_counter()
            cfg = get_config(arch).with_(
                remat=True, **({"n_layers": depth} if depth else {}))
            grads = _mesh_grads(dev, cfg.with_(n_layers=MESH_GRAD_DEPTH.get(
                arch, cfg.n_layers)), ctx)
            # a gate of the steps that fails is read after every case
            # has run (phase_mesh fails the phase on it)
            steps, failed = _mesh_steps(dev, cfg, mesh, arch, depth,
                                        "sp1" in grads)
            out["models"][arch] = dict(grads=grads, steps=steps,
                                       layers=cfg.n_layers, failed=failed)
            if profile and depth is None:
                out["models"][arch]["profile"] = _mesh_profile(dev, cfg,
                                                               mesh)
            out["models"][arch]["seconds"] = time.perf_counter() - t0
        out["sharded"] = {}
        for arch, depth in MESH_SHARDED:
            t0 = time.perf_counter()
            cfg = get_config(arch).with_(
                remat=True, **({"n_layers": depth} if depth else {}))
            out["sharded"][arch] = _mesh_sharded(dev, cfg, ctx, arch,
                                                 out_dir)
            out["sharded"][arch]["layers"] = cfg.n_layers
            out["sharded"][arch]["seconds"] = time.perf_counter() - t0
        # compressed_psum on the card against the CPU, on the card's draws
        x_of = [torch.randn(4096, generator=torch.Generator().manual_seed(
            SEED + r)) * (r + 1) for r in range(world)]
        got = compressed_psum(x_of[rank].to(dev), ("data", "model"),
                              torch.Generator(device=dev).manual_seed(
                                  SEED + rank), mesh=mesh).cpu()
        want = None
        for r in range(world):
            draws = torch.rand(4096, generator=torch.Generator(device=dev)
                               .manual_seed(SEED + r), device=dev).cpu()
            q = int8_round(x_of[r], draws)[0]
            want = q if want is None else want + q
        check(torch.equal(got, want), "compressed_psum on the card != the "
              "CPU's sum of int8_round on the same draws: max diff "
              f"{float((got - want).abs().max())}")
        out["compressed_psum_equal"] = True
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=float)


def phase_mesh(dev, model: int = 1, profile: bool = False) -> dict:
    """Phase 25: spawn torch.cuda.device_count() ranks of mesh_rank (on a
    ``(world // model, model)`` mesh, ``profile`` passed on) with a
    deadline, read every rank's readings, log rank 0's."""
    import torch
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  this process holds {torch.cuda.memory_allocated(dev) / 1e9:.2f}"
        " GB of the card while the ranks run")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        procs = mp.start_processes(mesh_rank,
                                   args=(world, f"{tmp}/pg", tmp, model,
                                         "cuda", profile),
                                   nprocs=world, join=False,
                                   start_method="spawn")
        try:
            while not procs.join(timeout=5):
                check(time.perf_counter() - t0 < MESH_TIMEOUT_S,
                      f"phase 25's {world} ranks still running after "
                      f"{MESH_TIMEOUT_S} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    out = ranks[0]
    log(f"  {world} NCCL rank(s), mesh {out['mesh']}, {wall:.1f} s with "
        "the spawn")
    for arch, r in out["models"].items():
        g = r["grads"]
        for sp in ("sp0", "sp1"):
            if sp not in g:
                log(f"  {arch}: no SP on this model axis (heads or d_ff do "
                    "not split)")
                continue
            log(f"  {arch} ({g['layers']} layers) {sp}: float32 "
                f"{g['rows']}x{GRAD_S} gradient on the mesh vs without: "
                f"loss {g[sp]['loss_err']:.3g}, worst leaf "
                f"{g[sp]['grad_err']:.3g} ({g[sp]['worst']}); launches "
                f"{g['launches']} in each; collectives (calls, bytes) "
                + ", ".join(f"{op} {c['calls']} {c['bytes']}"
                            for op, c in g[sp]["counts"].items()))
        for kind in ("one", "mesh"):
            st = r["steps"][kind]
            log(f"  {arch} {TRAIN_B}x{TRAIN_S} bf16 steps "
                f"{'on the mesh' if kind == 'mesh' else 'without a mesh'}: "
                f"losses {', '.join(f'{x:.5f}' for x in st['losses'])}; "
                f"step ms {', '.join(f'{x:.1f}' for x in st['step_ms'])}; "
                f"launches {st['launches']}")
        if "profile" in r:
            for kind, pr in r["profile"].items():
                log(f"  {arch} one {'mesh' if kind == 'mesh' else 'no-mesh'}"
                    f" step: wall {pr['wall_ms']:.1f} ms; under the "
                    f"profiler device busy {pr['busy_ms']:.1f} ms, NCCL "
                    f"kernels {pr['nccl_ms']:.1f} ms")
            log("  the mesh step's largest host operations: " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in r["profile"]["mesh"]
                ["host_ops"]))
        log(f"  {arch} took {r['seconds']:.1f} s in rank 0")
    world_note = "the mesh has one rank: a block is the whole leaf" \
        if world == 1 else f"{world} ranks"
    for arch, r in out["sharded"].items():
        for kind in ("sharded", "replicated"):
            st = r[kind]
            log(f"  {arch} ({r['layers']} layers) {TRAIN_B}x{TRAIN_S} bf16 "
                f"steps on the mesh, state {kind}: losses "
                f"{', '.join(f'{x:.5f}' for x in st['losses'])}; step ms "
                f"{', '.join(f'{x:.1f}' for x in st['step_ms'])}; "
                f"launches {st['launches']}")
        log(f"  {arch} state bytes a rank, sharded vs replicated "
            f"({world_note}): " + ", ".join(
                f"rank {i} {rk['sharded'][arch]['sharded']['state_bytes']}"
                for i, rk in enumerate(ranks))
            + f" vs {r['replicated']['state_bytes']}; peak GB a rank, "
            "sharded vs replicated: " + ", ".join(
                f"rank {i} {rk['sharded'][arch]['sharded']['peak_gb']:.2f} "
                f"vs {rk['sharded'][arch]['replicated']['peak_gb']:.2f}"
                for i, rk in enumerate(ranks)))
        log(f"  {arch} rank 0's peak GB by step, up to the optimizer | the "
            "optimizer's own (each above what the card holds besides the "
            "run's state; the other state holds no gradients): " + "; ".join(
                f"{kind} " + ", ".join(
                    f"{g:.2f} | {u:.2f}" for g, u in zip(
                        r[kind]["grads_peak_gb"], r[kind]["update_peak_gb"]))
                for kind in ("sharded", "replicated")))
        log(f"  {arch} blocks after {MESH_STEPS} steps vs the replicated "
            f"state's: worst {r['worst']:.3g} ({r['worst_leaf'] or 'every '
            'block bit-equal'})")
        if "checkpoint" in r:
            ck = r["checkpoint"]
            log(f"  {arch} sharded checkpoint ({ck['bytes'] / 1e9:.2f} GB, "
                "the reference's format): saved with mesh=/pspecs= in "
                f"{ck['save_s']:.1f} s, restored into another sharded "
                f"state in {ck['restore_s']:.1f} s, bit-equal")
        log(f"  {arch} sharded run took {r['seconds']:.1f} s in rank 0")
    log("  compressed_psum on the card bit-equal to the CPU's on the same "
        "draws in every rank")
    failed = sorted({what for rk in ranks for r in rk["models"].values()
                     for what in r["failed"]})
    check(not failed, "phase 25's steps: " + "; ".join(failed))
    out["wall_s"] = wall
    return out


# ===========================================================================
# phase 26: serving on a device mesh
# ===========================================================================

def _b7_block_check(dev) -> dict:
    """B7's block variant on the card: each case's cache split into
    SERVE_MESH_BLOCKS blocks of slots, each block launched with its
    ``slot0``, the whole cache's ``sc_total`` and ``return_lse`` and held
    per call against the plain version (B7's gate; lse within
    SERVE_LSE_TOL), the blocks combined in rank order against the whole
    cache's launch (gated in float32, logged in bf16); an empty block and
    a ring that wraps among the cases.
    Timed at mixtral's batch-1 ring (one block of its 4,096 slots): the
    kernel, the plain version, the bound of the block's valid slots and
    SDPA on the same block."""
    import torch

    from repro_torch.kernels import gqa_decode as gd

    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    n = SERVE_MESH_BLOCKS
    # (label, B, Sc, Hkv, G, hd, kv_len, window, ring): smollm's serving
    # decode (its last block empty), mixtral's batch-1 ring past 8,192
    # positions, zamba2's batch-1 cache of 8,224 slots, a window
    cases = [("smollm rows", SERVE_B, SERVE_SEQ, 5, 3, 64, [1040] * SERVE_B,
              0, False),
             ("mixtral ring", 1, 4096, 8, 4, 128, [8192 + 17], 0, True),
             ("zamba2 batch 1", 1, 8224, 32, 1, 80, [8200], 0, False),
             ("window", 2, 1024, 2, 3, 64, [1000, 300], 200, False)]
    worst = {"float32": 0.0, "bfloat16": 0.0, "lse": 0.0}
    empty = 0
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for label, B, Sc, Hkv, G, hd, lens, window, ring in cases:
            q = _randn((B, Hkv * G, hd), dt, gen)
            kc = _randn((B, Sc, Hkv, hd), dt, gen)
            vc = _randn((B, Sc, Hkv, hd), dt, gen)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            kw = dict(window=window, ring=ring)
            b = Sc // n
            outs, lses = [], []
            for r in range(n):
                blk = (kc[:, r * b:(r + 1) * b].contiguous(),
                       vc[:, r * b:(r + 1) * b].contiguous())
                n0 = gd.LAUNCHES["gqa_decode"]
                o, lse = gd.gqa_decode_cuda(q, *blk, kv_len, slot0=r * b,
                                            sc_total=Sc, return_lse=True,
                                            **kw)
                ro, rlse = gd.gqa_decode_ref(q, *blk, kv_len, slot0=r * b,
                                             sc_total=Sc, return_lse=True,
                                             **kw)
                torch.cuda.synchronize()
                check(gd.LAUNCHES["gqa_decode"] == n0 + 1,
                      f"B7 block {label}: not one launch")
                e = float((o.float() - ro.float()).abs().max())
                _held_in_ulps(o, ro, f"B7 block {label} {r}")
                check(dtype == "bfloat16" or e <= ATTN_TOL[dtype],
                      f"B7 block {label} {r} {dtype}: max abs {e}")
                none = rlse <= 0.5 * gd.ref.NEG
                check(torch.equal(lse <= 0.5 * gd.ref.NEG, none),
                      f"B7 block {label} {r}: empty (row, head)s differ")
                le = float((lse - rlse)[~none].abs().max()) if \
                    bool((~none).any()) else 0.0
                check(le <= SERVE_LSE_TOL, f"B7 block {label} {r} {dtype}: "
                      f"lse {le}")
                empty += int(none.all())
                worst[dtype] = max(worst[dtype], e)
                worst["lse"] = max(worst["lse"], le)
                outs.append(o)
                lses.append(lse)
            # combined: gated in float32 (in bf16 each block's output is
            # rounded before the combine, so where the blocks' outputs
            # cancel the sum is not within ulps of the whole cache's; the
            # per-call gate above is bf16's)
            whole = gd.gqa_decode_cuda(q, kc, vc, kv_len, **kw)
            got = gd.combine_blocks(torch.stack(outs), torch.stack(lses))
            e = float((got.float() - whole.float()).abs().max())
            check(dtype == "bfloat16" or e <= ATTN_TOL[dtype],
                  f"B7 blocks {label} combined {dtype}: max abs {e}")
            log(f"  B7 block variant {label} {dtype} [{B},{Sc},{Hkv}x{G},"
                f"{hd}] kv_len {lens[0]} window {window} ring {ring}, {n} "
                f"blocks: each within the gate of its plain version, the "
                f"combined blocks {e:.3g} off the whole cache's launch")
    check(empty > 0, "no B7 block case held an empty block")
    # timed: one block of mixtral's batch-1 ring (every slot valid)
    B, Sc, Hkv, G, hd = 1, 4096, 8, 4, 128
    b = Sc // n
    dt = torch.bfloat16
    q = _randn((B, Hkv * G, hd), dt, gen)
    kc = _randn((B, b, Hkv, hd), dt, gen)
    vc = _randn((B, b, Hkv, hd), dt, gen)
    kv_len = torch.tensor([8192 + 17], dtype=torch.int32, device=dev)

    def kernel():
        return gd.gqa_decode_cuda(q, kc, vc, kv_len, ring=True, slot0=b,
                                  sc_total=Sc, return_lse=True)

    n_ops, n_bytes = gd.gqa_decode_cost(B, Hkv, G, hd, 2, gd.decode_slots(
        [8192 + 17], b, ring=True, slot0=b, sc_total=Sc), True)
    bound, by = bound_ms(n_bytes, n_ops, BF16_OPS_S)
    out = dict(shape=[B, b, Hkv, G, hd], ms=time_ms(kernel),
               device_ms=device_ms_per_call(kernel, "gqa_decode_kernel"),
               plain_ms=time_ms(lambda: gd.gqa_decode_ref(
                   q, kc, vc, kv_len, ring=True, slot0=b, sc_total=Sc,
                   return_lse=True)),
               library_ms=time_ms(lambda: _sdpa(q[:, None], kc, vc)),
               bound_ms=bound, bound_by=by,
               max_abs_err=max(worst["float32"], worst["bfloat16"]),
               f32_err=worst["float32"], lse_err=worst["lse"],
               empty_blocks=empty)
    log(f"  B7 block variant timed: one {b}-slot block of mixtral's "
        f"{Sc}-slot batch-1 ring, bf16 {out['shape']}: kernel "
        f"{out['ms']:.4f} ms events, {out['device_ms']} ms device; plain "
        f"{out['plain_ms']:.4f} ms; sdpa {out['library_ms']:.4f} ms; bound "
        f"{bound:.4f} ms ({by})")
    torch.cuda.empty_cache()
    return out


class _HeldBlocks:
    """While entered, every B7 call the model layers make with
    ``return_lse`` (the block variant) is held against its plain version on
    the same inputs: the output within B7's gate, the lse within
    SERVE_LSE_TOL; the readings are kept."""

    def __enter__(self):
        import torch

        from repro_torch.models import layers

        self.orig, self.calls, self.worst = layers.decode_attention, 0, {}
        orig = self.orig

        def held(q, kc, vc, kv_len, **kw):
            out = orig(q, kc, vc, kv_len, **kw)
            if kw.get("return_lse") and q.is_cuda:
                o, lse = out
                ro, rlse = orig(q, kc, vc, kv_len,
                                **dict(kw, use_kernel=False))
                e = float((o.float() - ro.float()).abs().max())
                _held_in_ulps(o, ro, "B7 block call")
                check(o.dtype == torch.bfloat16 or e <= ATTN_TOL["float32"],
                      f"B7 block call: max abs {e}")
                none = rlse <= -5e29
                check(bool(((lse <= -5e29) == none).all()),
                      "B7 block call: empty (row, head)s differ")
                le = float((lse - rlse).abs()[~none].max()) \
                    if bool((~none).any()) else 0.0
                check(le <= SERVE_LSE_TOL, f"B7 block call: lse {le}")
                self.calls += 1
                self.worst[str(o.dtype)] = max(
                    self.worst.get(str(o.dtype), 0.0), e)
                self.worst["lse"] = max(self.worst.get("lse", 0.0), le)
            return out

        layers.decode_attention = held
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers

        layers.decode_attention = self.orig


def _serve_run(dev, model, cfg, tokens, ctx, max_seq: int, steps: int,
               shard_seq: bool = False) -> dict:
    """``prefill`` of ``tokens`` and ``steps`` greedy ``decode_step``
    calls (on ``ctx``'s mesh, or without one), the KV slots laid over the
    batch axes after the prefill where ``shard_seq``. On the mesh each
    rank gets its ``shard_batch`` block of the prompt and of each step's
    tokens and gives its block of the logits; the greedy tokens are the
    ``argmax`` of the logits gathered whole (``gather_logits``, inside the
    timed step, as a greedy server on the mesh must). Returns the
    prefill's whole logits and every token on the host, the prefill's ms
    and each step's (host clock, ended by a sync), the kernels' launches,
    the collectives of the last step's ``decode_step`` (calls and bytes),
    the bytes of a rank's prompt and prefill logits beside the whole
    ones', and the peak memory."""
    import torch

    from repro_torch.distributed import collectives as C
    from repro_torch.models import transformer as T

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def nbytes(t):
        return t.numel() * t.element_size()

    def blocks(tok):
        if ctx is None:
            return tok, None
        b, bctx = T.shard_batch({"tokens": tok}, ctx)
        return b["tokens"], bctx

    B = tokens.shape[0]
    _reset_launches()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    prompt, pctx = blocks(tokens)
    cache, ring = T.init_cache(cfg, B, max_seq, dev, ctx=pctx)
    sync()
    t = time.perf_counter()
    logits, cache = T.prefill(model, cfg, prompt, cache, ring, ctx=pctx)
    whole = T.gather_logits(logits, pctx, cfg)
    toks = [whole.argmax(-1)]
    sync()
    prefill_ms = 1e3 * (time.perf_counter() - t)
    first = whole.float().cpu()
    in_bytes = dict(prompt=nbytes(prompt), prompt_whole=nbytes(tokens),
                    logits=nbytes(logits), logits_whole=nbytes(whole))
    if shard_seq:
        cache = T.shard_cache(cache, ctx)
    step_ms = []
    for _ in range(steps):
        t = time.perf_counter()
        tok, dctx = blocks(toks[-1])
        C.reset_counts()
        logits, cache = T.decode_step(model, cfg, tok, cache, ring,
                                      ctx=dctx)
        counts = {op: dict(c) for op, c in C.COUNTS.items()}
        toks.append(T.gather_logits(logits, dctx, cfg).argmax(-1))
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t))
    out = dict(logits=first, tokens=torch.stack(toks).cpu(),
               prefill_ms=prefill_ms, step_ms=step_ms,
               launches=_launches(), step_counts=counts, bytes=in_bytes,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9
               if cuda else 0.0)
    del cache, logits
    return out


def _serve_pair(dev, model, cfg, tokens, ctx, max_seq: int, steps: int,
                shard_seq: bool = False) -> dict:
    """One ``_serve_run`` without the mesh and one on it. Without it an MoE
    model serves one group of rows a data rank (its prefill's capacity
    comes from a data rank's tokens, as on the mesh); launches are per
    group. Returns both readings and their comparison: the prefill logits'
    max |difference| over the no-mesh run's largest |logit|, and the
    greedy tokens' agreement."""
    import torch

    rows = tokens.shape[0]
    groups = ctx.data_size if cfg.n_experts and rows % ctx.data_size == 0 \
        else 1
    parts = [_serve_run(dev, model, cfg, g, None, max_seq, steps)
             for g in tokens.chunk(groups)]
    one = dict(parts[0],
               logits=torch.cat([p["logits"] for p in parts]),
               tokens=torch.cat([p["tokens"] for p in parts], 1),
               prefill_ms=sum(p["prefill_ms"] for p in parts),
               step_ms=[sum(s) for s in zip(*(p["step_ms"] for p in parts))])
    with _HeldBlocks() as held:
        on = _serve_run(dev, model, cfg, tokens, ctx, max_seq, steps,
                        shard_seq)
    logit_err = float((on["logits"] - one["logits"]).abs().max()) / float(
        one["logits"].abs().max())
    same = float((on["tokens"] == one["tokens"]).float().mean())
    drop = ("logits", "tokens")
    return dict(one={k: v for k, v in one.items() if k not in drop},
                mesh={k: v for k, v in on.items() if k not in drop},
                logit_err=logit_err, token_agreement=same,
                tokens_equal=bool(torch.equal(on["tokens"], one["tokens"])),
                block_calls=held.calls, block_worst=held.worst)


def mesh_serve_rank(rank: int, world: int, init_file: str, out_dir: str,
                    model: int = 1, device: str = "cuda",
                    seq: bool = False) -> None:
    """Phase 26 in one rank (a spawned process on card ``rank``): the NCCL
    process group, make_host_mesh(model=model), and for each SERVE_MESH
    model, in float32 and bfloat16 compute from the same float32 masters,
    SERVE_B x SERVE_PROMPT prompts and SERVE_STEPS greedy steps without and
    with the mesh (:func:`_serve_pair`); with ``seq`` also the
    SERVE_SEQ_CASES at batch 1 with the KV slots over the batch axes.
    Writes ``out_dir/rank<r>.json``. ``device="cpu"`` rehearses it with
    gloo."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import MeshContext

    if device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device(device)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        mesh = make_host_mesh(model=model, device=device)
        ctx = MeshContext(mesh, ("data",))
        out = {"world": world, "mesh": dict(zip(mesh.mesh_dim_names,
                                                tuple(mesh.shape))),
               "models": {}, "seq": {}}
        cases = [(a, d, SERVE_B, SERVE_PROMPT, SERVE_SEQ, SERVE_STEPS,
                  False, "models") for a, d in SERVE_MESH]
        if seq:
            cases += [(a, d, 1, prompt, slots, SERVE_STEPS, True, "seq")
                      for a, d, prompt, slots in SERVE_SEQ_CASES]
        for arch, depth, B, S, slots, steps, shard_seq, part in cases:
            t0 = time.perf_counter()
            cfg = get_config(arch, **({"n_layers": depth} if depth else {}))
            params = T.init_params(cfg, torch.Generator(device=dev)
                                   .manual_seed(SEED))
            tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
                0, cfg.vocab_size, (B, S)), device=dev)
            r = {"layers": cfg.n_layers}
            for dtype in ("float32", "bfloat16"):
                r[dtype] = _serve_pair(dev, params, cfg.with_(dtype=dtype),
                                       tokens, ctx, slots, steps, shard_seq)
            r["seconds"] = time.perf_counter() - t0
            out[part][arch] = r
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=float)


def _serve_gates(ranks: list, part: str) -> list:
    """The gates phase 26 fails on, read after every case has run: in
    float32 the mesh's greedy tokens equal to the no-mesh run's and its
    prefill logits within SERVE_MESH_TOL; in both dtypes each rank's
    launches equal to the no-mesh run's (per group of rows)."""
    failed = []
    for i, rk in enumerate(ranks):
        for arch, r in rk[part].items():
            f = r["float32"]
            if not (f["tokens_equal"] and f["logit_err"] <= SERVE_MESH_TOL):
                failed.append(f"rank {i} {arch} float32: prefill logits "
                              f"{f['logit_err']:.3g} (gate {SERVE_MESH_TOL})"
                              f", tokens equal {f['tokens_equal']} "
                              f"(agreement {f['token_agreement']:.4f})")
            for dtype in ("float32", "bfloat16"):
                x = r[dtype]
                if x["mesh"]["launches"] != x["one"]["launches"]:
                    failed.append(f"rank {i} {arch} {dtype}: mesh launches "
                                  f"{x['mesh']['launches']} != "
                                  f"{x['one']['launches']}")
    return failed


def phase_serve_mesh(dev, model: int = 1, seq: bool = False,
                     block: bool = True) -> dict:
    """Phase 26: B7's block variant on the card (:func:`_b7_block_check`,
    where ``block``), then torch.cuda.device_count() ranks of
    mesh_serve_rank (on a ``(world // model, model)`` mesh, ``seq`` passed
    on) spawned with a deadline; every rank's readings read, rank 0's
    logged, the gates checked after every case has run."""
    import torch
    import torch.multiprocessing as mp

    block = _b7_block_check(dev) if block else None
    world = torch.cuda.device_count()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        procs = mp.start_processes(mesh_serve_rank,
                                   args=(world, f"{tmp}/pg", tmp, model,
                                         "cuda", seq),
                                   nprocs=world, join=False,
                                   start_method="spawn")
        try:
            while not procs.join(timeout=5):
                check(time.perf_counter() - t0 < MESH_TIMEOUT_S,
                      f"phase 26's {world} ranks still running after "
                      f"{MESH_TIMEOUT_S} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    out = _log_serve_mesh(ranks, wall)
    out["block"] = block
    return out


def _log_serve_mesh(ranks: list, wall: float) -> dict:
    """Log rank 0's phase-26 readings (and every rank's launches), then
    check the gates."""
    out = ranks[0]
    log(f"  {out['world']} rank(s), mesh {out['mesh']}, {wall:.1f} s with "
        "the spawn")
    for part in ("models", "seq"):
        for arch, r in out[part].items():
            for dtype in ("float32", "bfloat16"):
                x = r[dtype]
                for kind in ("one", "mesh"):
                    s = x[kind]
                    steps = sorted(s["step_ms"])
                    log(f"  {arch} ({r['layers']} layers{', batch 1, KV '
                        'slots over the batch axes' if part == 'seq' else ''}"
                        f") {dtype} {'on the mesh' if kind == 'mesh' else
                                     'without a mesh'}: prefill "
                        f"{s['prefill_ms']:.1f} ms, decode median "
                        f"{steps[len(steps) // 2]:.2f} ms a step (min "
                        f"{steps[0]:.2f}, max {steps[-1]:.2f}), launches "
                        f"{ {k: n for k, n in s['launches'].items() if n} }"
                        f", peak {s['peak_gb']:.2f} GB"
                        + (", a decode step's collectives (calls, bytes) "
                           + ", ".join(f"{op} {c['calls']} {c['bytes']}"
                                       for op, c in s["step_counts"].items())
                           if kind == "mesh" else ""))
                b = x["mesh"]["bytes"]
                log(f"  {arch} {dtype}: a rank's prompt block "
                    f"{b['prompt']} bytes (whole {b['prompt_whole']}), its "
                    f"prefill logits block {b['logits']} bytes (whole "
                    f"{b['logits_whole']})")
                log(f"  {arch} {dtype}: prefill logits "
                    f"{x['logit_err']:.3g} of the largest |logit| off the "
                    f"no-mesh run, greedy tokens agree at "
                    f"{x['token_agreement']:.4f}"
                    + (f"; {x['block_calls']} B7 block calls held, worst "
                       f"{x['block_worst']}" if x["block_calls"] else ""))
            log(f"  {arch} took {r['seconds']:.1f} s in rank 0")
    same = [i for i, rk in enumerate(ranks) if all(
        rk[p][a][d]["mesh"]["launches"] == out[p][a][d]["mesh"]["launches"]
        for p in ("models", "seq") for a in rk[p]
        for d in ("float32", "bfloat16"))]
    log(f"  ranks {same} of {len(ranks)} launch what rank 0 launches on the "
        "mesh")
    failed = _serve_gates(ranks, "models") + _serve_gates(ranks, "seq")
    check(not failed, "phase 26: " + "; ".join(failed))
    out["wall_s"] = wall
    return out



# ===========================================================================
# phase 27: the dry run against the card
# ===========================================================================

#: The dry run's predicted peak of a step against the card's
#: max_memory_allocated over the same step: within this fraction.
DRY_RUN_PEAK_TOL = 0.10
#: The dry-run CLI's cell in a child process, and its time limit (s).
DRY_RUN_CELL = ("smollm_360m", "train_4k")
DRY_RUN_CHILD_S = 300
#: Layers of the cell whose traced argument bytes are held against its
#: real blocks'.
DRY_RUN_LAYERS = 4


def _dry_run_blocks(dev) -> dict:
    """smollm-360m's training cell at full width and DRY_RUN_LAYERS layers
    (the bytes a layer are the same at any depth), TRAIN_B x TRAIN_S
    tokens, on rank 0 of a fake (2, 2) process group
    (``launch.specs.cell_step``: the state's blocks and ``shard_batch``'s
    blocks of the batch): the
    argument bytes of its step traced on fake tensors on ``dev`` against
    the bytes of the same blocks made real (on the host: ``cell_step``
    draws from a CPU generator, as the dry run does), and the inputs'
    bytes a rank beside the whole batch's."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.analysis import tensors_of, trace_step
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.launch.specs import cell_step, training_config

    def storage_bytes(obj) -> int:
        return sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                    for t in tensors_of(obj)}.values())

    cfg = training_config("smollm_360m", 2).with_(n_layers=DRY_RUN_LAYERS)
    cell = ShapeCell("phase27", "train", TRAIN_S, TRAIN_B)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_host_mesh(model=2, device=dev.type)
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args, _ = cell_step(cfg, cell, mesh, False, device=dev)
            cost, _ = trace_step(step, *args)
            del step, args
        _, (state, batch), _ = cell_step(cfg, cell, mesh, False,
                                         device="cpu")
        real = storage_bytes((state, batch))
        inputs = storage_bytes(batch)
        whole = sum(TRAIN_B * TRAIN_S * t.element_size()
                    for t in batch.values())
        del state, batch
    finally:
        dist.destroy_process_group()
        C.reset_groups()
    traced = cost.memory["argument_size_in_bytes"]
    log(f"  smollm_360m ({DRY_RUN_LAYERS} layers) train {TRAIN_B}x{TRAIN_S} "
        f"on rank 0 of a fake (2, 2) mesh: traced argument bytes {traced}, "
        f"the real blocks {real}; of "
        f"them the inputs {inputs} bytes (the whole batch {whole})")
    check(traced == real, f"the traced step's argument bytes {traced} != "
          f"its real blocks' {real}")
    return dict(traced=traced, real=real, inputs=inputs, inputs_whole=whole)


def phase_dry_run(dev) -> dict:
    """Phase 12's one-card smollm-360m training step (TRAIN_B x TRAIN_S,
    remat, no mesh) traced by ``repro_torch.analysis.trace_step`` on fake
    CUDA tensors: its kernel calls against ``_per_step`` (the launches the
    card counts for the step), its predicted peak against
    ``torch.cuda.max_memory_allocated`` over one real step of the same
    configuration (within DRY_RUN_PEAK_TOL); and ``python -m
    repro_torch.launch.dryrun`` on DRY_RUN_CELL at pod16x16 in a child
    process (started first, so that it traces beside the rest)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import trace_step
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    out_dir = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    arch, shape = DRY_RUN_CELL
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--single-pod", "--out", str(out_dir)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        cfg = get_config("smollm_360m").with_(remat=True)
        opt = AdamWConfig(lr=TRAIN_LR)
        step = make_train_step(cfg, opt)
        pipe = TokenPipeline(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S,
                             seed=SEED)
        t1 = time.perf_counter()
        with FakeTensorMode(allow_non_fake_inputs=True):
            state = init_train_state(cfg, opt, torch.Generator(
                device=dev).manual_seed(SEED))
            batch = {k: torch.zeros(v.shape, dtype=getattr(torch, str(
                v.dtype)), device=dev) for k, v in pipe.batch_at(0).items()}
            cost, _ = trace_step(step, state, batch)
            del state, batch
        trace_s = time.perf_counter() - t1
        calls = {k: v["calls"] for k, v in cost.kernels.items()}
        want = {k: n for k, n in _per_step(cfg).items() if n}
        log(f"  traced on fake CUDA tensors in {trace_s:.1f} s: kernel calls "
            f"{calls} (the card's launches a step: {want}); dot FLOPs "
            f"{cost.dot_flops:.4g}, FLOPs {cost.flops:.4g}, bytes at op and "
            f"kernel boundaries {cost.hbm_bytes:.4g}; memory {cost.memory}")
        check(calls == want, f"dry run kernel calls {calls} != {want}")

        # the same step on the card, from a fresh state
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        state = init_train_state(cfg, opt, gen)
        batch = _train_batch(pipe, 0, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated(dev) - base
        launches = {k: n for k, n in _launches().items() if n}
        check(launches == want, f"the real step's launches {launches}")
        check(bool(torch.isfinite(metrics["loss"])), "the real step's loss")
        predicted = cost.memory["peak_bytes"]
        rel = predicted / measured - 1
        log(f"  peak of one step: predicted {predicted / 1e9:.4f} GB "
            f"(arguments {cost.memory['argument_size_in_bytes'] / 1e9:.4f} "
            f"GB, per_device_hbm_bytes "
            f"{cost.memory['per_device_hbm_bytes'] / 1e9:.4f} GB), measured "
            f"max_memory_allocated {measured / 1e9:.4f} GB above the "
            f"{base / 1e9:.4f} GB held before the state: {100 * rel:+.2f} %"
            f" (gate {100 * DRY_RUN_PEAK_TOL:.0f} %)")
        del state, batch, metrics
        torch.cuda.empty_cache()
        check(abs(rel) <= DRY_RUN_PEAK_TOL,
              f"dry run peak {predicted} vs measured {measured} ({rel:+.3%})")
        blocks = _dry_run_blocks(dev)

        stdout, stderr = child.communicate(timeout=DRY_RUN_CHILD_S)
        child_s = time.perf_counter() - t0
        line = next((x for x in stdout.splitlines() if x.startswith("[")),
                    stdout.strip())
        log(f"  python -m repro_torch.launch.dryrun --arch {arch} --shape "
            f"{shape} --single-pod (child, {child_s:.1f} s from the phase's "
            f"start; the fake process group under torch "
            f"{torch.__version__}): {line}")
        check(child.returncode == 0 and line.startswith("[ok]"),
              f"the dry-run CLI: rc {child.returncode}: {stderr[-2000:]}")
        rec = json.loads((out_dir / f"{arch}__{shape}__pod16x16.json"
                          ).read_text())
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)
    return dict(calls=calls, predicted_peak=predicted, measured_peak=measured,
                rel=rel, trace_s=trace_s, cli=line, cli_trace_s=rec["trace_s"],
                cli_memory=rec["memory"], blocks=blocks)

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    # cuBLAS reads this when its first handle is made: deterministic
    # products for the bitwise resume check of phase 12
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.core import max_impls_of, synthetic_instance

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    phase_build()

    t0 = time.perf_counter()
    inst = synthetic_instance(U_MAIN, n_edges=E_MAIN, seed=SEED)
    P, K = inst.P, max_impls_of(inst)
    log(f"  main-path instance U={inst.U} E={inst.E} P={P} S={inst.S} "
        f"M={K} ({time.perf_counter() - t0:.2f} s on the host)")

    log("phase 2: kernels vs plain versions")
    kern = phase_kernels(dev, inst)

    log(f"phase 3/4: main path at U={U_MAIN}, E={E_MAIN}")
    main_path = phase_main_path(dev, inst)

    log("phase 5: paper scale vs host oracle; the dense batched path")
    phase_paper_scale(dev)
    phase_batched(dev)

    log("phase 6: attention kernels vs plain versions")
    kern.update(phase_attention_kernels(dev))

    def serve(phase: int, arch: str) -> dict:
        log(f"phase {phase}: serving {arch}, {SERVE_B} prompts x "
            f"{SERVE_PROMPT} tokens, {SERVE_STEPS} new tokens")
        return phase_serving(dev, arch)

    served = {"smollm_360m": serve(7, "smollm_360m")}
    log("phase 8: SSD scan kernel vs plain versions")
    kern.update(phase_ssd_kernel(dev))
    served.update(mamba2_2p7b=serve(9, "mamba2_2p7b"),
                  zamba2_2p7b=serve(10, "zamba2_2p7b"))
    log("phase 11: flash-attention backward kernels vs plain versions")
    kern.update(phase_backward_kernels(dev))
    log(f"phase 12: training smollm_360m, {TRAIN_STEPS} steps of "
        f"{TRAIN_B} x {TRAIN_S} tokens")
    trained = phase_training(dev)
    log("phase 13: the sweep engine (repro_torch.sweeps) at the paper's "
        "widths")
    t13 = time.perf_counter()
    swept = phase_sweeps(dev)
    log(f"  phase 13 took {time.perf_counter() - t13:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    log("phase 14: the serving tick (traced 10^6-user tick, every "
        "scenario's horizon, a serving sweep)")
    t14 = time.perf_counter()
    kept = tempfile.TemporaryDirectory(dir=ROOT / "build")
    serving_store = Path(kept.name) / "serving"
    ticked = phase_serving_tick(dev, inst, main_path,
                                keep_store=serving_store)
    log(f"  phase 14 took {time.perf_counter() - t14:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    log("phase 15: serving the MoE family at full width, depth cut "
        f"({MOE_DEPTH})")
    t15 = time.perf_counter()
    moe = {}
    for arch, depth in MOE_DEPTH.items():
        log(f"phase 15: serving {arch} ({depth} layers), {SERVE_B} prompts "
            f"x {SERVE_PROMPT} tokens, {SERVE_STEPS} new tokens")
        moe[arch] = phase_serving(dev, arch, depth)
    log(f"  phase 15 took {time.perf_counter() - t15:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    log("phase 16: the audio and vision frontends at full width and depth")
    t16 = time.perf_counter()
    fronts = phase_frontends(dev)
    log(f"  phase 16 took {time.perf_counter() - t16:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    log(f"phase 17: the edge cluster (run_serving at {CLUSTER_CASES}, edge "
        f"{CLUSTER_FAIL_EDGE} failing)")
    t17 = time.perf_counter()
    cluster = phase_cluster(dev)
    log(f"  phase 17 took {time.perf_counter() - t17:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    log("phase 18: the live control plane (profiled tick, virtual-clock "
        "gateway, wall-clock soak over TCP, the Pareto mask on the card)")
    t18 = time.perf_counter()
    try:
        control = phase_control_plane(dev, serving_store)
    finally:
        kept.cleanup()
    log(f"  phase 18 took {time.perf_counter() - t18:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    log("phase 19: the SSD scan's backward kernel vs the float64 plain "
        "backward")
    t19 = time.perf_counter()
    bwd_row, head_block_fwd = phase_ssd_bwd_kernel(dev)
    kern.update(bwd_row)
    kern["ssd_scan"]["head_block"] = head_block_fwd
    log(f"  phase 19 took {time.perf_counter() - t19:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    log(f"phase 20: training {', '.join(SSM_TRAINED)}, {TRAIN_STEPS} steps "
        f"of {TRAIN_B} x {TRAIN_S} tokens")
    t20 = time.perf_counter()
    trained_ssm = phase_ssm_training(dev)
    log(f"  phase 20 took {time.perf_counter() - t20:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    log(f"phase 21: training every remaining family ({', '.join(
        FAMILY_TRAINED)}) and the hd-16 smoke configs through run_training")
    t21 = time.perf_counter()
    trained_fam = phase_family_training(dev)
    log(f"  phase 21 took {time.perf_counter() - t21:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    log(f"phase 22: the fleet on the card ({FLEET_WORKERS} worker "
        f"processes, one SIGKILLed) against one process; the sweep CLI's "
        f"--fleet 2")
    t22 = time.perf_counter()
    fleet = phase_fleet(dev)
    log(f"  phase 22 took {time.perf_counter() - t22:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    log("phase 23: the int8 implementation variants at full width "
        "(smollm_360m, mamba2_2p7b)")
    t23 = time.perf_counter()
    quant = phase_quant(dev)
    log(f"  phase 23 took {time.perf_counter() - t23:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    log(f"phase 24: compressed training of smollm_360m "
        f"({', '.join(COMPRESSIONS)}), {TRAIN_STEPS} steps of {TRAIN_B} x "
        f"{TRAIN_S} tokens")
    t24 = time.perf_counter()
    compressed = phase_compressed_training(dev, trained)
    log(f"  phase 24 took {time.perf_counter() - t24:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    # each kernel's launches on its slice's main path: B4/B7 serving
    # smollm-360m, B8 serving mamba2-2.7b, B5/B6 training smollm-360m, the
    # SSD backward training mamba2-2.7b
    log(f"phase 25: the device mesh on the card ({', '.join(
        a for a, _ in MESH_MODELS)}; make_host_mesh(model=1) over "
        f"{torch.cuda.device_count()} NCCL rank(s))")
    t25 = time.perf_counter()
    meshed = phase_mesh(dev)
    log(f"  phase 25 took {time.perf_counter() - t25:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    log(f"phase 26: serving on the device mesh ({', '.join(
        a for a, _ in SERVE_MESH)}; B7's block variant; "
        f"{torch.cuda.device_count()} NCCL rank(s))")
    t26 = time.perf_counter()
    served_mesh = phase_serve_mesh(dev)
    kern["gqa_decode"]["block"] = served_mesh["block"]
    log(f"  phase 26 took {time.perf_counter() - t26:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    log("phase 27: the dry run against the card (phase 12's step traced on "
        "fake CUDA tensors; the dry-run CLI on "
        f"{' '.join(DRY_RUN_CELL)} in a child process)")
    t27 = time.perf_counter()
    dry = phase_dry_run(dev)
    log(f"  phase 27 took {time.perf_counter() - t27:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    launches = {**main_path["launches"],
                **served["smollm_360m"]["launches"],
                **served["mamba2_2p7b"]["launches"],
                **{k: trained["launches"][k]
                   for k in ("flash_attention_dq", "flash_attention_dkv")},
                "ssd_scan_bwd":
                    trained_ssm["mamba2_2p7b"]["launches"]["ssd_scan_bwd"]}

    log(card)
    rows = [dict(name=name, route="cuda", source=SOURCE[name],
                 replaces=REPLACES[name], launches=launches[name],
                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=r["library_ms"],
                 shape=r["shape"], **{k: r[k] for k in EXTRA_KEYS if k in r})
            for name, r in kern.items()]
    for row in rows:
        if row["name"] in ("qos_matrix", "greedy_argmax"):
            row["sweep_launches"] = swept["fig3"]["launches"][row["name"]]
        if row["name"] in ("qos_candidates", "greedy_argmax"):
            row["trace_launches"] = ticked["trace"]["launches"][row["name"]]
        if row["name"] in ("flash_attention", "gqa_decode"):
            row["moe_launches"] = {a: r["launches"][row["name"]]
                                   for a, r in moe.items()}
            row["frontend_launches"] = {
                a: r["launches"].get(row["name"], 0)
                for a, r in fronts.items()}
        if row["name"] in ("qos_matrix", "flash_attention", "gqa_decode",
                           "ssd_scan"):
            row["cluster_launches"] = cluster["launches"][row["name"]]
        if row["name"] in ("ssd_scan", "ssd_scan_bwd", "flash_attention",
                           "flash_attention_dq", "flash_attention_dkv"):
            row["training_launches"] = {
                a: r["launches"][row["name"]] for a, r in
                [*trained_ssm.items(), *trained_fam.items(),
                 *((f"{a} tiny", r) for a, r in
                   trained_fam["tiny"].items()),
                 *((f"smollm_360m {m}", r) for m, r in
                   compressed.items())] if a != "tiny"}
        if row["name"] in ("flash_attention", "flash_attention_dq",
                           "flash_attention_dkv", "ssd_scan",
                           "ssd_scan_bwd"):
            row["mesh_launches"] = {
                f"{a} {kind}": r["steps"][kind]["launches"][row["name"]]
                for a, r in meshed["models"].items()
                for kind in ("one", "mesh")}
            row["mesh_launches"].update({
                f"{a} {kind} state": r[kind]["launches"][row["name"]]
                for a, r in meshed["sharded"].items()
                for kind in ("sharded", "replicated")})
        if row["name"] in ("flash_attention", "gqa_decode", "ssd_scan"):
            row["mesh_serve_launches"] = {
                f"{a} {d} {kind}": r[d][kind]["launches"][row["name"]]
                for a, r in served_mesh["models"].items()
                for d in ("float32", "bfloat16") for kind in ("one", "mesh")}
        if row["name"] in dry["calls"]:
            row["dry_run_calls"] = dry["calls"][row["name"]]
        if row["name"] in fleet["launches"]:
            row["fleet_launches"] = fleet["launches"][row["name"]]
        for arch, r in quant.items():
            if row["name"] in r["launches"]:
                row["quant_launches"] = {arch: r["launches"][row["name"]]}
        if row["name"] in control["profile"]["kernels"]:
            prof = control["profile"]["kernels"][row["name"]]
            row["profile_launches"] = prof["launches"]
            row["profile_device_ms"] = prof["device_ms"]
            row["profile_ms_per_launch"] = prof["ms_per_launch"]
    log("dry_run " + json.dumps({k: dry[k] for k in (
        "predicted_peak", "measured_peak", "rel", "calls", "cli",
        "cli_trace_s", "blocks")}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
