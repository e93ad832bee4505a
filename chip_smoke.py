#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. the card: nvidia-smi's name and power limit, torch's device name; TF32 off;
2. build the CUDA kernels from the sources in this checkout (nvcc, sm_90a);
3. hold the three flash-attention routes (the wgmma kernel for bf16 at
   head_dim 64 and every multiple of 8 from 72 to 128, the mma kernel for
   f32 and every other head_dim up to 256, the wide kernel above 256)
   against their plain PyTorch version on the card at the test shapes
   (head_dim 72, 80, 96, 112 and 120 included), strided views of a fused
   projection, a planted fault of the wgmma kernel below hd 128 (tensor
   maps of 128 columns, reading large values past each head's columns of
   a fused projection) that the check must fail,
   the serving shape and the served shapes of chatglm3-6b (16 query heads
   a KV head) and zamba2-7b (MHA at hd 112), whisper-medium's (the encoder
   non-causal at a ragged 1500 x 1500, cross-attention at T != S, the
   decoder's causal 448) and llava-next-34b's (a GQA group of 7 at hd 128,
   3904 positions), each call counted on the route that the table names;
   then time both at the serving shape beside the plain version, the bound
   and, as a yardstick the port never calls,
   ``torch.nn.functional.scaled_dot_product_attention``; and the mma route
   in bf16 at the training slice's shape beside SDPA (printed only); the
   wgmma route at h2o-danube-3-4b's hd 120 and zamba2-7b's hd 112 beside the
   mma route on the same inputs, SDPA and the bound; the wide route at
   head_dim 512 and 1024 beside its plain version and SDPA;
4. hold the SSD chunked-scan kernel (output and final state) against its
   plain version (the token-by-token recurrence) on the card at the test
   shapes, a ragged S, S < chunk and the serving shape, and again with a
   slow decay that carries the state across many chunks (the slice, 32
   chunks, a chunk of 100, grids smaller and larger than the card), and at
   the (P, N) the wrapper slices or pads, (128, 256) and (48, 96), and at
   zamba2-7b's (112 heads, state 64); then time it at the serving shape
   beside the plain version (no single PyTorch call computes it) and its
   bound, the faster of the f32 CUDA cores and the TF32 tensor cores at
   three products (3xTF32), or bytes; and at zamba2-7b's shape (printed);
5. hold the flash-attention backward kernel against its plain version on
   the card (tests/test_kernels.py's grid at S = 192: MHA, GQA, MQA, causal
   on and off, windows 32 and 96, softcap 20; f32 and bf16 at head_dim 32,
   64 and 128; and the edges), check that two calls at llama3.2-1b's
   training shape give the same bits, then time it there beside the plain
   version, its bound and, as a yardstick the port never calls, the backward
   of ``scaled_dot_product_attention``, with its device time by pass; and in
   f32 beside SDPA's f32 backward and its bound (printed only);
   then hold the SSD backward kernel against its plain version (autograd
   through the chunked scan) at small, ragged, sliced and padded shapes and
   at mamba2-370m's and zamba2-7b's training shapes, each on fast- and
   slow-decay inputs; a planted fault (the adjoint's carry across chunks
   dropped) must fail that check; two calls must give the same bits; then
   time it at both training shapes beside the plain version and its bound,
   with its device time by pass;
6. serve full-width llama3.2-1b (bf16, seeded random weights): 4 prompts of
   1024 tokens, one-pass prefill, 32 greedy decode steps, with each flash
   route's launches counted over that run (all 16 on the wgmma route); then
   check the prefill against the same forward with the plain attention, the
   cache against a prefill one token longer; serve and check the same model
   in f32 (all 16 launches on the mma route), and the reduced model on
   the card against the CPU;
7. the same for full-width mamba2-370m, with the SSD kernel's launches
   counted and the plain SSD scan as the comparison, a planted fault that
   the bf16 check must reject, and the checks repeated in f32; then for
   zamba2-7b (the hybrid: 81 Mamba blocks, the shared attention block
   after every 6 of them, 13 calls of the wgmma route and 81 of the SSD
   kernel a bf16 prefill; plain attention and plain scan together as the
   comparison, the same planted fault), chatglm3-6b and internlm2-20b
   (the wgmma route at hd 128) and h2o-danube-3-4b (the wgmma route at hd
   120, and a 6144-token prompt on which its 4096-token window binds, with
   the window left out as a planted fault), each at full width and depth
   in bf16 and again in f32 (internlm2-20b's f32 at 24 of its 48 layers:
   all 48 do not fit the card in f32);
   then the moe family: granite-moe-1b-a400m and granite-moe-3b-a800m at
   full width and depth in bf16 (24 / 32 launches of the wgmma route a
   prefill) and in f32 (the mma route), the (token, choice) routes that
   differ between the kernel and the plain prefill counted by layer, a
   planted GQA fault (KV heads rotated) that the bf16 check must fail, and
   decode checked at capacity factor E / k, where no choice drops; train
   full-width granite-moe-1b-a400m (the wgmma forward 48 and the backward
   24 times a step, the first step against the plain attention, moe_aux,
   an f32 repeat holding every gradient leaf, the router's included, a
   traced step split into dispatch/combine, experts, attention and other);
   the compressed all-reduce (``comms.compression``) of train_lm's 100m
   gradient tree at 8 ranks stacked: q, scale and residual of every leaf
   and rank equal to the CPU's bit for bit, each rank its own scale, the
   mean within the quantization bound, 50 error-feedback steps' drift,
   timed beside the uncompressed stacked mean and its bound;
8. train full-width llama3.2-1b on the card (bf16 compute, f32 master
   params and AdamW state, 4 x 1024 tokens a step): the first step's loss
   and gradient norm beside the same step through the plain attention
   forward and backward, then three timed steps with each flash kernel's
   launches counted over them; then the same for full-width mamba2-370m
   and for zamba2-7b at full width and 13 of its 81 layers (the SSD scan
   and its backward, and zamba2's shared attention block, through their
   kernels; the plain scan, scan backward and attention as the
   comparison; the flash backward at the shared block's shape checked and
   timed beside SDPA's backward, by CUDA events and device time, and its
   bound), each with its launches counted exactly, one traced step,
   and the first step repeated in f32 with every SSM gradient leaf held to
   the plain one;
9. the data-parallel step of train_lm's 100m model with 8 ranks stacked on
   the card, PCCL beside the built-in reduction: the ``PCCL_CONFORMANCE``
   line, every rank's params equal bit for bit after each step;
10. checkpoint and recovery: (a) full-width llama3.2-1b through train_lm
   (f32 master weights and AdamW state, bf16 compute, remat, 4 x 1024
   tokens a step) runs 4 steps uninterrupted (U); then 3 steps saving the
   state after 2 updates as label 2, its write in flight during step 2
   (C); then resumes from label 2 (R): C's and R's losses within rtol 1e-6
   of U's, the restored AdamW step 2, R's flash launches exact; the
   checkpoint's bytes, snapshot, write and restore seconds, step 2's ms
   with the write in flight beside U's, and whether the losses and R's
   params are bit-equal to U's; (b) train_lm's 100m in f32 with 8 ranks
   stacked and PCCL: NPU 7 fails, the reference's recovery loop built from the
   port's modules repairs the data-parallel all-reduce for the 7
   survivors (validated, no transfer touches NPU 7) and restores the
   checkpoint; the repaired all-reduce runs once at the gradient
   vector's size (NPU 7's row NaN in, exact zeros out), timed; a dp = 7
   run resumes within the DP phase's limits of the uninterrupted dp = 8
   run; (c) NPUs 3 and 7 fail, which splits the ring: the recovery raises
   ``FabricDegradedError`` before any restore;
11. the collective path: the executor's selftest on the card; the four
   fig_exec routes (8 ranks, 4096 f32 a shard) with their round and send
   counts, bit for bit against the port's numpy round interpreter and
   within 1e-5 of a plain sum; and the all-reduce of mamba2-370m's f32
   gradient vector over a bidirectional ring of 8 ranks held in one tensor
   on the card, bit for bit on a column sample, against ``x.sum(0)``, with
   exact zeros off a subgroup of 5, timed beside ``x.sum(0)``;
12. plan repair, on the same stacked backend: BENCH_synthesis.json's
   fig_repair_64 (a 64-NPU three-level all-gather repaired after a pod's
   internal link fails) with its strategy, phases kept and re-synthesized,
   makespan and transfers gated, the repaired and the cold plan each run at
   4096 f32 a shard, bit for bit against the numpy interpreter and the
   plain gather, no transfer on the failed link, timed in turns, the
   repaired one traced; all-reduces of mamba2-370m's gradient vector
   repaired on the DP ring after a failed link and on the mp222 multi-pod
   fabric after a failed pod-internal link and after a failed NPU (its row
   NaN in, exact zeros out), each beside its undamaged plan; the
   reference's repair fault at check_repair_seed(60973), which the copy
   fixes, executed; a repair that must refuse (every boundary link cut)
   and its failure count; fig_repair_512 gated, lowered and run at 256 f32
   a shard; then limited switch buffers: star_switch(8) at buffers of 1, 2
   and 4 chunks and two_level_switch(2, 4) at 1 and 2, each under
   all_gather, all_to_all, reduce_scatter, all_reduce and pipelined
   all_reduce, synthesized by the planner copy, validated, each limited
   switch's peak occupancy against its limit, lowered to rounds (switch
   hops unrolled) and run at 4096 f32 a shard on the stacked backend, bit
   for bit against the numpy interpreter and exactly (reductions within
   1e-5) the plain collective; one arrival shifted into a full buffer as a
   planted fault that validate() must reject; four threads synthesizing on
   one shared star_switch(8) at a buffer of 2, every plan the single-thread
   plan;
13. the planner examples (``repro_torch.examples``): synthesize_pod's and
   quickstart's output; quickstart's All-Gather over group (0, 3, 12) of
   the 4x4 mesh on 16 ranks stacked on the card, NPU 0 gathering [1, 4,
   13], held bit for bit (the members' inputs in group order, zeros at the
   13 other NPUs, the numpy interpreter's bits), with its last round
   dropped as a planted fault that must fail; then the same plan carrying
   one llama3.2-1b layer's bf16 weights (20.27 M a member), held the same
   way, timed beside the plain gather and its rounds' bytes;
14. serve_batch: the example at its defaults on the card, every step's
   logits held to a CPU run of ``serve_stepped``; then full-width
   llama3.2-1b, 4 prompts of 128 tokens stepped through ``decode_step``
   and 32 greedy tokens, in bf16 and f32: the stepped logits against the
   one-pass prefill through the flash kernel (16 launches of the wgmma
   route in bf16, of the mma route in f32), the prompt stepped at
   positions shifted by one as a planted fault in bf16, the stepped and
   one-pass prefill ms, decode ms a step and tokens/s;
15. the sharding policy: (a) ``LM(policy=)`` on a one-rank NCCL group and
   a data = 1 x model = 1 mesh, full-width llama3.2-1b in bf16 with its
   params as DTensors: prefill of 4 x 1024, 32 greedy decode steps and one
   training step (f32 master weights), each bit for bit the same as
   without the policy, the flash launches counted exactly, the times with
   and without it; (b) ``pad_heads`` at model = 16 with
   ``bridge.pad_head_params``: granite-moe-3b-a800m at full depth (24 -> 32
   heads, experts 40 -> 48) and llava-next-34b at 8 of its 60 layers (56 ->
   64 heads), the padded model against the unpadded one over the prefill
   and 8 decode steps in bf16 and f32 (f32 rel-L2 <= 1e-5; bf16 at the
   serving phases' limits, moe's first-layer route flips too); the
   reference's layout (pad heads appended, zero wo rows) as a planted fault
   that must fail the f32 check; the wgmma route at both padded attention
   shapes (GQA groups 4 and 8) timed beside SDPA and its bound; (c) the
   policy path of (a) at model = 1 for the ssm, hybrid and encdec families:
   full-width mamba2-370m, zamba2-7b at 13 layers and whisper-medium at
   full depth in bf16, a prefill (4 x 1024; whisper 4 x 416 over 4 x 1500
   stub frames), 8 greedy decode steps and one training step each bit for
   bit as without the policy, the SSD and flash launches counted exactly,
   the times with and without it; (d) the kernels at a tensor-parallel
   rank's share of the heads at model = 2 and 4: the SSD scan and its
   backward at mamba2-370m's 16 and 8 and zamba2-7b's 56 and 28 SSD
   heads, the flash forward and backward at whisper-medium's 8 and 4 of 16
   heads (encoder, cross and decoder shapes), each against its plain
   version, timed beside it, its bound and (flash) SDPA, with the head
   grouping of the SSD backward printed and whether a rank's heads equal
   the same heads of the full call bit for bit;
16. the step builders (``launch/steps.py``) on a one-rank NCCL group and a
   data = 1 x model = 1 mesh: (a) all 40 cells of the shape table on both
   production meshes built as bundles of meta-device stand-ins, the card's
   allocated memory unchanged; (b) full-width llama3.2-1b's train kind at
   train_lm's first step (4 x 1024 tokens) at accum 1 and 2: accum 1's
   loss against ``Trainer.step``'s, accum 2 against accum 1 (loss and
   gradient norm), the f32 gradient sum left undivided by accum as a
   planted fault that must fail, then three timed steps of each with the
   flash launches counted exactly, step ms and peak memory; (c) the
   prefill kind at 4 x 1024 and one step of the decode kind over the
   prefill's cache, bit for bit the same as ``LM`` without a policy, the
   prefill's launches counted;
17. the launchers (``launch/train.py``, ``launch/serve.py``) on a one-rank
   NCCL group, the mesh data = 1 x model = 1: (a) full-width llama3.2-1b
   trained for 10 steps at 4 x 1024 through ``launch.train.train`` (f32
   params and AdamW, remat, the policy's DTensors; the reference's cadence
   saves nothing before step 10): the first loss bit for bit against
   ``Trainer.step``'s on the same params and batch, a pipeline started one
   batch late as a planted fault that must fail it, the flash launches of
   the 10 steps counted exactly (32 ``wgmma`` and 16 backward a step), the
   step ms (median of steps 1-9), peak memory, straggler verdicts and
   losses; (b) ``serve.main`` at full width, 4 x 1024 and 32 new tokens
   under the mesh and policy: tokens and logits bit for bit against
   ``serve()`` on ``LM`` without a policy, 16 ``wgmma`` launches;
18. the dry run (``launch/dryrun.py``) and the kernels' ``torch.library``
   operators: (a) the four kernels through ``torch.ops.repro_torch`` at the
   slice shapes, two calls bit for bit against the wrapper called directly
   and within the check's tolerance of the plain version, the host time a
   call through the operator beside the wrapper's; (b) the dry run's
   prediction of full-width llama3.2-1b's bundle steps at 4 x 1024 on a
   data = 1 x model = 1 mesh (the train kind at accum 1 and 2, prefill, one
   decode step over a 1024-deep cache; a fake group of one in a child
   process) beside the same steps run on the card in a one-rank NCCL group
   with arguments placed as the dry run places them: argument bytes equal,
   argument + temp bytes within 10% of ``max_memory_allocated``, the
   predicted FLOPs over the step's median time; (c) the production dry
   run on fake CUDA DTensors on a fake group of 256 ranks in child
   processes: ``python -m repro_torch.launch.dryrun --arch llama3.2-1b
   --mesh pod`` (its four shapes, long_500k skipped), ``launch.train
   --dry-run`` and ``launch.serve --dry-run``, each cell's FLOPs and
   collective bytes a device, its predicted peak beside the card's memory,
   its trace seconds, and the card's allocated memory unchanged;
19. print one JSON line of per-kernel numbers (the wgmma route's at hd 120
   and 112 beside the mma route, SDPA and the bound under ``head_dims``, the
   mma backward's at zamba2-7b's shared block under ``zamba2_shape``; each
   kernel's numbers at the
   per-rank shapes of (d) under ``tp_shapes``, the bundle steps' launches
   under ``steps_launches``, the launchers' under ``launch_launches``, the
   host time a call through the operator and through the wrapper under
   ``op_host_us`` and ``wrapper_host_us``);
20. print the result line ``{"ok": true, "device": {...}}`` last.

Imports nothing of jax or of the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, TF32 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12

F32_TOL = 2e-5
BF16_TOL = 2e-2
# bf16 model logits: relative L2 error ||a - b|| / ||b||. The two sides of
# each comparison round to bf16 at different places (kernel vs plain
# attention output order; decode's bf16 scores and probabilities vs the
# kernel's f32), and 16 layers compound it.
LOGITS_REL_TOL = 5e-2
REDUCED_F32_TOL = 1e-4
# llama3.2-1b logits in f32 (the mma route), rel-L2: the kernel and the
# plain attention differ by f32 summation order and the ~2^-22 residue of
# the 3xTF32 products
LLAMA_F32_REL_TOL = 1e-3
# the SSD kernel against the token-by-token recurrence, f32 (the tolerance
# of tests/test_kernels.py's SSD tests)
SSD_TOL = 1e-4

# mamba2 logits, rel-L2. In bf16 the kernel and the plain scan sum in
# other orders in f32, which flips bf16 roundings of the block outputs, and
# decode's conv runs in f32 on an f32 window where prefill's runs in bf16
# (as in the reference); the random-weight 48-layer stack amplifies such
# flips to ~0.1. So the bf16 limit is loose, and each run shows that it
# still fails a planted fault: the same forward with an off-by-one causal
# mask in the scan must miss the plain one by more than the limit. The same
# checks on the same model in f32 carry the weight: there the two sides
# differ only by f32 summation order. Neither sees the state carried across
# chunks: with the reference's init (dt_bias = A_log = 0) the state decays
# by ~exp(-0.7) a token, so the SSD kernel checks above hold the carry.
SSM_BF16_REL_TOL = 0.3
SSM_F32_REL_TOL = 1e-3
# zamba2-7b (81 Mamba blocks and 13 calls of the shared attention block):
# the same reasoning and limits as mamba2's, with the same planted fault
HYBRID_BF16_REL_TOL = SSM_BF16_REL_TOL
HYBRID_F32_REL_TOL = SSM_F32_REL_TOL
# the reduced hybrid checked card against CPU: a tail group like zamba2-7b's
# 81 = 13 x 6 + 3 (2 groups of 3 Mamba blocks, then 1)
HYBRID_TAIL = dict(num_layers=7, hybrid_attn_period=3)
# internlm2-20b's f32 weights (79.4 GB at 48 layers) do not fit the card:
# its f32 repeat keeps the full width and this many layers
INTERNLM2_F32_LAYERS = 24
# h2o-danube-3-4b's window (4096) binds only past 4096 tokens: one prompt
# this long is checked with the window left out as the planted fault
WINDOW_PROMPT = 6144

SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 1024, 32
SLICE_SHAPE = (SERVE_BATCH, SERVE_PROMPT, 32, 8, 64)  # B, S, H, KV, hd
# the encdec and vlm families. whisper-medium decodes a 416-token prompt and
# 32 new tokens (448 positions, its published text context) over 1500 stub
# audio frames; llava-next-34b puts 2880 stub image patches ahead of a
# 1024-token prompt (3936 positions with the 32 new tokens)
WHISPER_PROMPT = 416
WHISPER_TEXT = WHISPER_PROMPT + SERVE_NEW
WHISPER_FRAMES = 1500
LLAVA_PATCHES = 2880
LLAVA_SEQ = LLAVA_PATCHES + SERVE_PROMPT  # positions of a llava prefill
# the attention shapes these serve and train at (B, S, T, H, KV, hd, causal):
# whisper's encoder (non-causal, 1500 x 1500, ragged), decoder self-attention
# (causal) and cross-attention (non-causal, T != S), llava's causal GQA at a
# group of 7 (one row; the plain version's f32 scores take 3.4 GB a row)
ENCDEC_VLM_SHAPES = {
    "whisper encoder": (SERVE_BATCH, WHISPER_FRAMES, WHISPER_FRAMES, 16, 16, 64, False),
    "whisper cross": (SERVE_BATCH, WHISPER_TEXT, WHISPER_FRAMES, 16, 16, 64, False),
    "whisper decoder": (SERVE_BATCH, WHISPER_TEXT, WHISPER_TEXT, 16, 16, 64, True),
    "llava": (1, LLAVA_SEQ, LLAVA_SEQ, 56, 8, 128, True),
}

# bf16 head dims below 128 that the wgmma route runs through its hd-128
# instance, beyond zamba2-7b's 112 and h2o-danube's 120
WGMMA_PADDED_HEAD_DIMS = (72, 80, 96)

CHECK_CASES = [  # B, S, T, H, KV, hd, dtype, kwargs
    (1, 128, 128, 4, 4, 32, "float32", dict(causal=True)),            # MHA
    (1, 128, 128, 4, 4, 32, "float32", dict(causal=False)),
    (2, 128, 128, 4, 2, 32, "float32", dict(causal=True)),            # GQA
    (2, 128, 128, 4, 2, 32, "float32", dict(causal=False)),
    (1, 256, 256, 8, 1, 16, "float32", dict(causal=True)),            # MQA
    (1, 256, 256, 8, 1, 16, "float32", dict(causal=False)),
    (1, 192, 192, 2, 2, 64, "float32", dict(causal=True)),            # S=192
    (1, 192, 192, 2, 2, 64, "float32", dict(causal=False)),
    (1, 256, 256, 4, 4, 32, "float32", dict(causal=True, window=32)),
    (1, 256, 256, 4, 4, 32, "float32", dict(causal=True, window=96)),
    (1, 128, 128, 2, 2, 32, "float32", dict(causal=True, softcap=20.0)),
    (1, 128, 128, 4, 2, 32, "bfloat16", dict(causal=True)),
    (1, 1000, 1000, 4, 2, 64, "float32", dict(causal=True)),          # ragged S
    (1, 1000, 1000, 4, 2, 64, "bfloat16", dict(causal=True)),
    (1, 96, 160, 4, 2, 128, "float32", dict(causal=False)),           # T != S
    (1, 64, 8, 2, 2, 16, "float32", dict(causal=True, window=4)),     # empty rows
    # bf16 at head_dim 64 / 128: the wgmma route
    (1, 128, 128, 4, 4, 64, "bfloat16", dict(causal=True)),           # MHA
    (2, 128, 128, 4, 2, 64, "bfloat16", dict(causal=False)),          # GQA
    (1, 256, 256, 8, 1, 64, "bfloat16", dict(causal=True)),           # MQA
    (1, 256, 256, 4, 4, 64, "bfloat16", dict(causal=True, window=32)),
    (1, 256, 256, 4, 4, 64, "bfloat16", dict(causal=True, window=96)),
    (1, 128, 128, 2, 2, 64, "bfloat16", dict(causal=True, softcap=20.0)),
    (1, 96, 160, 4, 2, 64, "bfloat16", dict(causal=False)),           # T != S
    (1, 64, 8, 2, 2, 64, "bfloat16", dict(causal=True, window=4)),    # empty rows
    (2, 1000, 1000, 8, 2, 128, "bfloat16", dict(causal=True)),        # hd 128
    # more work tiles than SMs: each persistent block walks several
    (2, 1000, 1000, 32, 8, 64, "bfloat16", dict(causal=True, window=96)),
    (4, 300, 700, 32, 4, 64, "bfloat16", dict(causal=False)),
    (4, 512, 8, 32, 8, 64, "bfloat16", dict(causal=True, window=4)),  # empty work tiles
    (3, 1000, 1000, 16, 4, 128, "bfloat16", dict(causal=True, softcap=20.0)),
    # zamba2-7b's 112 and h2o-danube's 120: the wgmma route in bf16 (the
    # hd-128 instance, TMA zero-filling the columns past hd), mma in f32
    *[case for hd in (112, 120) for dt in ("float32", "bfloat16") for case in (
        (1, 1000, 1000, 4, 2, hd, dt, dict(causal=True)),             # ragged, GQA
        (1, 256, 256, 4, 4, hd, dt, dict(causal=True, window=96)),
        (1, 128, 128, 2, 2, hd, dt, dict(causal=True, softcap=20.0)),
        (1, 64, 8, 2, 2, hd, dt, dict(causal=True, window=4)),         # empty rows
    )],
    # the other bf16 head dims below 128 that the wgmma route takes
    *[case for hd in WGMMA_PADDED_HEAD_DIMS for case in (
        (1, 1000, 1000, 4, 2, hd, "bfloat16", dict(causal=True)),      # ragged, GQA
        (1, 96, 160, 4, 4, hd, "bfloat16", dict(causal=False)),        # T != S, MHA
        (1, 256, 256, 4, 4, hd, "bfloat16", dict(causal=True, window=96, softcap=20.0)),
        (1, 64, 8, 2, 2, hd, "bfloat16", dict(causal=True, window=4)),  # empty rows
        (2, 1000, 1000, 32, 8, hd, "bfloat16", dict(causal=True)),     # work > SMs
    )],
    # bf16 head dims the wgmma route does not take (no multiple of 8): mma
    (1, 256, 256, 4, 2, 100, "bfloat16", dict(causal=True)),
    (1, 96, 160, 4, 2, 116, "bfloat16", dict(causal=False)),
    (1, 200, 300, 4, 2, 20, "float32", dict(causal=True)),            # hd 20, T != S
    (1, 300, 200, 4, 1, 256, "bfloat16", dict(causal=True)),          # the widest hd
    # head dims above 256: the wide route (257: no multiple of 8; 1024 and
    # 4096: two and eight column slices of the grid)
    *[(1, 300, 300, 4, 2, hd, dt, kw) for hd in (257, 320, 384, 512)
      for dt in ("float32", "bfloat16")
      for kw in (dict(causal=True, window=96, softcap=20.0), dict(causal=True))],
    *[case for dt in ("float32", "bfloat16") for case in (
        (1, 96, 160, 4, 2, 257, dt, dict(causal=False)),              # T != S
        (1, 64, 8, 2, 2, 320, dt, dict(causal=True, window=4)),        # empty rows
        (1, 200, 200, 4, 2, 1024, dt, dict(causal=True)),
        (1, 64, 64, 2, 1, 4096, dt, dict(causal=True)),
    )],
    # served shapes no row above reaches: chatglm3-6b's 16 query heads a KV
    # head (wgmma in bf16, mma in f32), zamba2-7b's MHA at hd 112 and
    # h2o-danube's prefill at hd 120 (wgmma in bf16, mma in f32)
    (4, 1024, 1024, 32, 2, 128, "bfloat16", dict(causal=True)),
    (4, 1024, 1024, 32, 2, 128, "float32", dict(causal=True)),
    (4, 1024, 1024, 32, 32, 112, "bfloat16", dict(causal=True)),
    (4, 1024, 1024, 32, 32, 112, "float32", dict(causal=True)),
    (4, 1024, 1024, 32, 8, 120, "bfloat16", dict(causal=True, window=4096)),
    # granite-moe-3b-a800m's 24 query heads on 8 KV heads: a GQA group of 3
    # (wgmma in bf16, mma in f32)
    (4, 1024, 1024, 24, 8, 64, "bfloat16", dict(causal=True)),
    (4, 1024, 1024, 24, 8, 64, "float32", dict(causal=True)),
    # the encdec and vlm shapes: whisper's encoder, cross- and decoder
    # self-attention in bf16 (wgmma) and f32 (mma), llava's group of 7 at
    # hd 128 in bf16 (wgmma) and f32 (mma)
    *[(B, S, T, H, KV, hd, dt, dict(causal=causal))
      for B, S, T, H, KV, hd, causal in ENCDEC_VLM_SHAPES.values()
      for dt in ("bfloat16", "float32")],
    (SLICE_SHAPE[0], SLICE_SHAPE[1], SLICE_SHAPE[1], *SLICE_SHAPE[2:],
     "float32", dict(causal=True)),                                   # the slice, f32
    (SLICE_SHAPE[0], SLICE_SHAPE[1], SLICE_SHAPE[1], *SLICE_SHAPE[2:],
     "bfloat16", dict(causal=True)),                                  # the slice
]
# q/k/v as views of one [B, S, (H + 2 KV) hd] projection (heads not contiguous)
FUSED_CASES = [  # B, S, H, KV, hd, dtype, kwargs
    (2, 130, 4, 1, 64, "bfloat16", dict(causal=True)),
    (2, 130, 4, 1, 32, "float32", dict(causal=True)),
    *[(2, 130, 4, 1, hd, dt, dict(causal=True))
      for hd in (112, 120, 320, 512) for dt in ("float32", "bfloat16")],
    *[(2, 130, 4, 1, hd, "bfloat16", dict(causal=True)) for hd in WGMMA_PADDED_HEAD_DIMS],
]
# the mma route in bf16, timed beside SDPA (causal): B, S, H, KV, hd
YARDSTICKS = {"the 10m training model": (8, 256, 8, 4, 32)}
# the served bf16 head dims below 128, on the wgmma route: timed beside the
# mma route on the same inputs, SDPA and the bound (causal; B, S, H, KV, hd)
PADDED_HEAD_DIM_SHAPES = {
    "h2o-danube-3-4b": (SERVE_BATCH, SERVE_PROMPT, 32, 8, 120),
    "zamba2-7b": (SERVE_BATCH, SERVE_PROMPT, 32, 32, 112),
}
# the planted fault of the wgmma route below hd 128: a copy of the kernel
# whose tensor maps span the instance's 128 columns instead of the call's
# hd, run on q/k/v as views of one projection with large values just past
# each head's hd columns (B, S, H, KV at each hd)
WGMMA_FAULT_CASE = (2, 200, 4, 2)
WGMMA_FAULT_HEAD_DIMS = (112, 120)

# the wide route, timed beside its plain version and SDPA (causal): B, S, H,
# KV, hd; the first goes to the kernels line
WIDE_SHAPE = (2, 1024, 8, 2, 512)
WIDE_SHAPES = (WIDE_SHAPE, (*WIDE_SHAPE[:4], 1024))

SSD_SLICE = (SERVE_BATCH, SERVE_PROMPT, 32, 64, 128, 128)  # B, S, H, P, N, chunk
ZAMBA2_SSD = (SERVE_BATCH, SERVE_PROMPT, 112, 64, 64, 128)  # zamba2-7b's prefill
SSD_CASES = [  # B, S, H, P, N, chunk, slow decay
    (1, 64, 2, 16, 8, 16, False),       # tests/test_kernels.py's shapes
    (2, 128, 4, 32, 16, 32, False),
    (1, 96, 2, 16, 8, 32, False),
    (1, 64, 1, 64, 32, 64, False),
    (2, 1000, 4, 64, 128, 128, False),  # ragged last chunk
    (1, 50, 2, 64, 64, 128, False),     # S < chunk, N = 64
    (2, 100, 8, 32, 16, 16, False),     # the reduced mamba2 shape
    (*SSD_SLICE, False),                # the slice
    # slow decay (dt scaled by 0.02): the state a chunk passes on lasts
    # several chunks, where at dt = softplus(randn) a chunk of 128 decays it
    # by ~e^-100 and only the previous chunk's own state reaches the next
    (*SSD_SLICE, True),                 # the slice
    (1, 4096, 4, 64, 128, 128, True),   # 32 chunks
    (2, 1000, 4, 64, 128, 100, True),   # chunk no multiple of 16, ragged
    (1, 256, 4, 64, 128, 128, True),    # fewer blocks than SMs
    (2, 2048, 32, 64, 128, 128, True),  # more blocks than SMs
    (*ZAMBA2_SSD, False),                # zamba2-7b's shape, both decays
    (*ZAMBA2_SSD, True),
    # sizes the kernel is not built for: P and N sliced or padded, chunk cut
    *[(1, 300, 4, P, N, chunk, slow) for P, N in ((128, 256), (48, 96))
      for chunk, slow in ((128, False), (256, True))],
]

# the backward kernel against its plain version: B, S, T, H, KV, hd, dtype,
# kwargs; the last is llama3.2-1b's training shape, where it is timed
TRAIN_SHAPE = SLICE_SHAPE  # B, S, H, KV, hd: 4 sequences of 1024 tokens a step
BWD_CASES = [
    *[case for hd in (32, 64, 128) for dt in ("float32", "bfloat16") for case in (
        (1, 192, 192, 4, 4, hd, dt, dict(causal=True)),               # MHA
        (1, 192, 192, 4, 4, hd, dt, dict(causal=False)),
        (2, 192, 192, 4, 2, hd, dt, dict(causal=True)),               # GQA
        (2, 192, 192, 4, 2, hd, dt, dict(causal=False)),
        (1, 192, 192, 8, 1, hd, dt, dict(causal=True)),               # MQA
        (1, 192, 192, 8, 1, hd, dt, dict(causal=False)),
        (1, 192, 192, 4, 2, hd, dt, dict(causal=True, window=32)),
        (1, 192, 192, 4, 2, hd, dt, dict(causal=True, window=96)),
        (1, 192, 192, 4, 2, hd, dt, dict(causal=True, softcap=20.0)),
    )],
    (1, 96, 160, 4, 2, 64, "float32", dict(causal=False)),            # T != S
    (1, 64, 8, 2, 2, 32, "bfloat16", dict(causal=True, window=4)),    # empty rows
    (1, 300, 200, 4, 2, 20, "float32", dict(causal=True)),            # hd padded to 32
    (1, 130, 130, 4, 2, 100, "bfloat16", dict(causal=True, window=50, softcap=20.0)),
    # the encdec and vlm training shapes: non-causal at a ragged T = 1500,
    # T != S, and llava's GQA group of 7 at hd 128 (one row), in bf16; the
    # whisper shapes in f32 too
    *[(B, S, T, H, KV, hd, dt, dict(causal=causal))
      for B, S, T, H, KV, hd, causal in ENCDEC_VLM_SHAPES.values()
      for dt in (("bfloat16", "float32") if H == 16 else ("bfloat16",))],
    # granite-moe-1b-a400m's training shape: 16 query heads on 8 KV heads
    (TRAIN_SHAPE[0], TRAIN_SHAPE[1], TRAIN_SHAPE[1], 16, 8, 64, "bfloat16",
     dict(causal=True)),
    (TRAIN_SHAPE[0], TRAIN_SHAPE[1], TRAIN_SHAPE[1], *TRAIN_SHAPE[2:], "bfloat16",
     dict(causal=True)),
]
TRAIN_STEPS = 3  # timed, after one warm-up step
# the first step's loss through the kernels against the same step through
# the plain attention, relative: bf16 rounds at other places in the two
TRAIN_LOSS_REL_TOL = 1e-3
# the SSD backward: mamba2-370m's and zamba2-7b's training shapes (B, S, H,
# P, N, chunk); the first goes to the kernels line
SSD_BWD_SHAPES = {"mamba2-370m": (TRAIN_SHAPE[0], TRAIN_SHAPE[1], 32, 64, 128, 128),
                  "zamba2-7b": (TRAIN_SHAPE[0], TRAIN_SHAPE[1], 112, 64, 64, 128)}
# H no power of two, where the kernel groups heads (G > 1); this and
# SSD_BWD_TOL are imported by tests/test_torch_cuda.py and
# tests/test_torch_ssm_train.py
SSD_BWD_GROUP_CASES = [(4, 2048, 6, 64, 128, 128, True), (1, 2048, 12, 64, 128, 128, True)]
SSD_BWD_CASES = [  # B, S, H, P, N, chunk, slow decay
    (1, 64, 2, 16, 8, 16, False),       # the scan's test shapes
    (2, 128, 4, 32, 16, 32, True),
    (1, 50, 2, 64, 64, 128, False),     # S < chunk: one chunk, no carry
    (2, 1000, 4, 64, 128, 128, True),   # ragged last chunk
    (2, 1000, 4, 64, 128, 100, True),   # chunk no multiple of 16
    (1, 4096, 4, 64, 128, 128, True),   # 32 chunks
    (2, 2048, 32, 64, 128, 128, True),  # more blocks than SMs
    # sizes the kernel is not built for: P and N sliced or padded, chunk cut
    (1, 300, 4, 128, 256, 256, True),
    (1, 300, 4, 48, 96, 128, False),
    (2, 100, 2, 8, 4, 40, True),
    # the training shapes, both decays
    *[(*shape, slow) for shape in SSD_BWD_SHAPES.values() for slow in (False, True)],
    # H no power of two, where the kernel groups heads (G > 1): each group's
    # dB and dC summed over its heads, then over the groups
    *SSD_BWD_GROUP_CASES,
]
# the SSD backward kernel against its plain version (autograd through the
# chunked scan), f32: max |got - want| <= SSD_BWD_TOL * max |want| for each
# gradient (``compare_scaled``). An element of dA, ddt, dB or dC is a sum of
# many terms of both signs (dA over every position of the batch), so its
# f32 rounding scales with the gradient's largest elements, not with its
# own size, and the two sum in other orders (the kernel's d(log decay) as
# row and column sums of W o CB^T and a reverse prefix sum, the plain one
# by autograd of each exp; both take the prefix sums of dt * A in f64).
SSD_BWD_TOL = SSD_TOL
# mamba2-370m and zamba2-7b training steps in f32: each SSM gradient leaf
# through the kernels against the plain scan and backward, rel-L2. As the
# f32 logits checks (SSM_F32_REL_TOL): the two differ by summation order
# and the forward's 3xTF32 residue, compounded over the layers.
SSM_GRAD_REL_TOL = 1e-3
# zamba2-7b trains at full width and this many of its 81 layers (two groups
# of 6 Mamba blocks, the shared block after each, a tail of 1): its 6.75 B
# params at 16 bytes each (f32 weights, gradients, two AdamW moments) do
# not fit the card
ZAMBA2_TRAIN_LAYERS = 13
# the flash backward at zamba2-7b's shared block (B, S, H, KV, hd), bf16
ZAMBA2_ATTN = (TRAIN_SHAPE[0], TRAIN_SHAPE[1], 32, 32, 112)
# its times (``zamba2_bwd_times``), filled by zamba2-7b's training phase
ZAMBA2_BWD: dict = {}
# the moe family (granite-moe-1b-a400m, granite-moe-3b-a800m), served at
# full width and depth. A bf16 difference between the kernel and the plain
# attention flips near-tie routes (0.7-0.8% of the first layer's (token,
# choice) pairs), a flip moves the later pairs' queue places in that
# expert and reroutes its token from there on, and by the last of 24 / 32
# layers 31% / 43% of the pairs go to another expert. With the experts'
# 1/sqrt(E) init the random-weight logits then differ by rel-L2 0.684 /
# 1.01 (granite-1b / 3b, NVIDIA H100 80GB HBM3, 700.00 W); the planted GQA
# fault reads 1.43 / 1.41, near sqrt(2), the rel-L2 of unrelated logits.
# So the bf16 logits limit is loose, and the first MoE layer, ahead of any
# rerouted token, carries the bf16 check: its share of pairs sent to
# another expert is held to MOE_FIRST_LAYER_ROUTES (the fault: 0.90 /
# 0.92). The f32 repeats hold LLAMA_F32_REL_TOL (7.2e-5 / 1.2e-4). Decode
# from the prefilled cache is held to a prefill one token longer at
# capacity factor E / k, where no (token, choice) pair drops and a token
# routes alike in any group; at the configs' 1.25 a decode step's capacity
# is ~1 slot an expert.
MOE_ARCHS = ("granite-moe-1b-a400m", "granite-moe-3b-a800m")
MOE_BF16_REL_TOL = 1.2
# the share of the first MoE layer's (token, choice) pairs that the kernel
# prefill sends to another expert than the plain one: ahead of any layer
# whose routes differed, so random-weight depth does not blur it
MOE_FIRST_LAYER_ROUTES = 0.05
# granite-moe-1b-a400m trains at full width and depth (21.4 GB of f32
# weights, gradients and AdamW moments); granite-3b's 52.8 GB adds no path
MOE_TRAIN_ARCH = MOE_ARCHS[0]
# its f32 repeat holds every gradient leaf to SSM_GRAD_REL_TOL at full
# width and this many layers, where the kernel and the plain attention
# route every (token, choice) pair alike (checked): deeper, a route that
# f32 summation order flips reroutes its token from there on, and the
# gradient leaves of the full 24 layers differ by rel-L2 ~0.07 (PERF.md §6)
MOE_F32_GRAD_LAYERS = 6
# llava-next-34b trains at full width and the most layers whose training
# state leaves this much of the card (``llava_train_layers``): activations
# at 4 x 3904 positions with remat (the f32 logits and their gradient alone
# take 2.1 GB), AdamW's per-leaf temporaries (a few copies of the largest
# leaf, 587 MB a layer) and the plain comparison's dense f32 scores and
# probabilities at one row (3.4 GB each, before AdamW's moments exist)
LLAVA_TRAIN_RESERVE = 30e9
LLAVA_NO_F32 = ("its plain backward's dense f32 scores take 13.7 GB a tensor at 4 rows, "
                "and the f32 first step is held at whisper-medium's and the other families'")
# whisper-medium's bf16 logits, rel-L2, against the plain attention: as
# LOGITS_REL_TOL, over 24 encoder and 24 decoder layers (0.0203 and, for
# decode against a longer prefill, 0.0144; the causal-encoder fault 1.36)
ENCDEC_BF16_REL_TOL = LOGITS_REL_TOL
# llava-next-34b's bf16 logits, rel-L2: 60 random-weight layers at d_model
# 7168 compound bf16 rounding to 0.0376 (prefill against the plain
# attention) and 0.0406 (decode against a longer prefill, whose attention
# keeps its probabilities in f32 where decode's rounds them to bf16) on
# NVIDIA H100 80GB HBM3, 700.00 W, near LOGITS_REL_TOL; the planted GQA
# fault reads 1.43 and decode at the wrong position 1.01, so the limit sits
# at twice the readings, and the f32 repeat (5e-5) carries the check
VLM_BF16_REL_TOL = 0.1
# llava-next-34b's f32 repeat keeps the full width and this many of its 60
# layers: all 60 take 137.6 GB in f32
LLAVA_F32_LAYERS = 8
LLAVA_F32_WHY = (f"{LLAVA_F32_LAYERS} of them keep the f32 prefills (the products without "
                 f"TF32) to seconds each")
# the compression phase: train_lm's model whose gradient tree is
# compressed, its ranks stacked, rank r's gradients scaled by 2^(r - 4);
# the error-feedback steps of the drift check and its limit
# (tests/test_comms.py's)
COMPRESS_MODEL, COMPRESS_RANKS = "100m", 8
DRIFT_STEPS, DRIFT_TOL = 50, 1e-3
# the data-parallel step: train_lm's model, ranks stacked on the card,
# steps, global batch and sequence; the limits of the conformance line
# that tests/test_exec_conformance.py holds examples/train_lm.py to
DP_MODEL, DP_RANKS, DP_STEPS, DP_BATCH, DP_SEQ = "100m", 8, 3, 8, 256
DP_LOSS_TOL, DP_PARAM_TOL = 1e-4, 1e-3
# the checkpoint phase: (a) run U takes CKPT_STEPS steps; run C stops one
# step short, the state after CKPT_LABEL updates saved as label CKPT_LABEL;
# run R resumes from it. A resumed loss against the uninterrupted one,
# relative: the reference's own bound (tests/test_substrate.py:154)
CKPT_STEPS, CKPT_LABEL = 4, 2
RESUME_RTOL = 1e-6
# (b) train_lm's model, ranks stacked, and a global batch that splits over
# 8 ranks and over 7; the NPUs that fail, and (c) two that split the ring
ELASTIC_MODEL, ELASTIC_RANKS, ELASTIC_BATCH, ELASTIC_SEQ = "100m", 8, 56, 256
ELASTIC_DEAD, SPLIT_DEAD = (7,), (3, 7)

# the collective phase: BENCH_synthesis.json's fig_exec rows
# (benchmarks/exec_mesh.py's cases), tag -> (fabric, kind, request
# keywords, rounds, sends), 8 ranks, EXEC_PAYLOAD f32 a shard
FIG_EXEC = {
    "ag_ring8": ("ring8", "all_gather", {"hierarchy": "never"}, 8, 56),
    "rs_ring8": ("ring8", "reduce_scatter", {"hierarchy": "never"}, 8, 56),
    "ar_hier8": ("grid23", "all_reduce", {"hierarchy": "always", "pipelined": True}, 18, 112),
    "a2a_mp8": ("mp222", "all_to_all", {"hierarchy": "always"}, 27, 96),
}
EXEC_RANKS, EXEC_PAYLOAD = 8, 4096
EXEC_TOL = 1e-5  # the conformance suite's tolerance for reductions
SUBGROUP = (0, 2, 3, 5, 6)  # a strict subgroup of 5 of the 8 ranks
SAMPLE_COLS = 4096  # columns of each chunk held bit for bit against numpy
# the plan-repair phase: BENCH_synthesis.json's fig_repair rows
# (benchmarks/repair.py:_scenario), name -> (three_level's pods, racks and
# NPUs a rack; the row's strategy, phases kept, phases re-synthesized,
# makespan, transfers and the cold plan's makespan), which the phase gates
FIG_REPAIR = {
    "fig_repair_64": ((4, 4, 4), ("phases", 7, 2, 132.0, 4352, 64.0)),
    "fig_repair_512": ((8, 8, 8), ("phases", 15, 2, 1036.0, 266240, 577.0)),
}
REPAIR_SCALE_PAYLOAD = 256  # f32 a shard of fig_repair_512's all-gather
# the switch buffers phase: label -> (generator, its arguments, buffer limit),
# each under every kind of SWITCH_KINDS (kind, pipelined), 8 NPUs
SWITCH_FABRICS = {
    **{f"star8_b{b}": ("star_switch", (8,), b) for b in (1, 2, 4)},
    **{f"two2x4_b{b}": ("two_level_switch", (2, 4), b) for b in (1, 2)},
}
SWITCH_KINDS = (("all_gather", False), ("all_to_all", False), ("reduce_scatter", False),
                ("all_reduce", False), ("all_reduce", True))
SWITCH_THREADS, SWITCH_JOIN_S = 4, 120.0
# tests/test_repair_property.py's check_repair_seed(60973): the reference's
# repair of a planned reduce_scatter over three_level(2, 2, 2) stops on a
# bare AssertionError under this event
SEED_60973_EVENT = {"failed_links": [11, 18, 20], "failed_npus": [5]}
# the examples phase: quickstart's All-Gather over group (0, 3, 12) of the
# 4x4 mesh, NPU d holding d + 1, gathers this at NPU 0; then the same plan
# carries one layer of GATHER_ARCH in bf16, split over the 3 members
QUICKSTART_GATHERED = [1.0, 4.0, 13.0]
GATHER_ARCH = "llama3.2-1b"
# the serve_batch phase: the example at its defaults (batch, prompt, new
# tokens; reduced llama3.2-1b in f32), then full-width llama3.2-1b stepped
# over SERVE_BATCH prompts of STEPPED_PROMPT tokens and STEPPED_NEW tokens
SERVE_BATCH_DEFAULTS = (4, 32, 16)
# the sharding policy phase: (a) LM(policy=) on a one-rank NCCL group and a
# data = 1 x model = 1 mesh, full-width llama3.2-1b in bf16, held bit for
# bit to LM without a policy; (b) pad_heads at model = 16, the padded model
# with pad_head_params weights against the unpadded one: granite-moe-3b-a800m
# at full depth (24 -> 32 heads, experts 40 -> 48), llava-next-34b at its f32
# repeat's 8 layers (56 -> 64 heads), prefill and 8 decode steps in bf16 and
# f32. A pad head adds exact zeros, so f32 differs only by the order of the
# wo products' sums; bf16 is held to the serving phases' limits (moe: the
# first layer's route flips as well)
POLICY_ARCH = "llama3.2-1b"
PAD_TP = 16
PAD_CASES = (("granite-moe-3b-a800m", None), ("llava-next-34b", LLAVA_F32_LAYERS))
PAD_DECODE = 8
PAD_F32_REL_TOL = 1e-5
# f32 at the cases' depth is held to the serving phases' f32 limit: the
# card's f32 products at other shapes (K = 32 vs 24 heads x hd in wo, 48 vs
# 40 experts) round apart by ~1e-7 a layer, which depth compounds past 1e-5
# and which flips granite's routes in later layers. The phase prints that
# floor: the unpadded model at half the batch against its own rows. The
# 1e-5 limit is held where neither reaches it: granite at 1 layer, llava at 2
PAD_F32_LAYERS = {"granite-moe-3b-a800m": 1, "llava-next-34b": 2}
PAD_BF16_REL_TOL = {"granite-moe-3b-a800m": MOE_BF16_REL_TOL,
                    "llava-next-34b": VLM_BF16_REL_TOL}
STEPPED_PROMPT, STEPPED_NEW = 128, 32
# (c) the policy path at model = 1 for the families whose blocks run
# head-parallel Mamba2 and a Megatron encoder at model > 1 (arch, layers or
# None for all), held bit for bit to LM without a policy over a prefill,
# POLICY_FAMILY_DECODE decode steps and one training step
POLICY_FAMILY_CASES = (("mamba2-370m", None), ("zamba2-7b", ZAMBA2_TRAIN_LAYERS),
                       ("whisper-medium", None))
POLICY_FAMILY_DECODE = 8
# (d) the kernels at one rank's share of the heads at these "model" sizes:
# the SSD scan and its backward at the serving and training shapes of
# mamba2-370m (32 SSD heads) and zamba2-7b (112), the flash forward and
# backward at whisper-medium's (16 heads, MHA: its KV heads split alike)
TP_DEGREES = (2, 4)
TP_SSD_SHAPES = {"mamba2-370m": SSD_SLICE, "zamba2-7b": ZAMBA2_SSD}
TP_FLASH_SHAPES = ("whisper encoder", "whisper cross", "whisper decoder")
# the steps phase: launch/steps.py's bundles, full-width llama3.2-1b at one
# rank (data = 1 x model = 1) of a one-rank NCCL group: the train kind at
# train_lm's first step (4 x 1024 tokens) at each accum, the first step
# held to Trainer.step's loss and accum 2 to accum 1 (the microbatches'
# gradient norm within 1e-2: each microbatch's bf16 gradients round apart
# from the whole batch's); the prefill kind at 4 x 1024, one decode step
STEPS_ARCH = "llama3.2-1b"
STEPS_SHAPE = (SERVE_PROMPT, SERVE_BATCH)  # seq_len, global_batch
STEPS_ACCUMS = (1, 2)
STEPS_TIMED = 3  # timed steps of each accum, after one warm-up
STEPS_LOSS_REL_TOL = 1e-3
STEPS_GNORM_REL_TOL = 1e-2
# the launch phase: launch/train.py's train at full width, 4 sequences of
# 1024 tokens a step (no card holds train_4k's 256 x 4096 at one rank), and
# serve.main under the mesh and policy
LAUNCH_ARCH = "llama3.2-1b"
LAUNCH_SHAPE = (SERVE_PROMPT, SERVE_BATCH)  # seq_len, global_batch
LAUNCH_STEPS = 10  # the reference's cadence saves nothing before step 10
LAUNCH_GNORM_REL_TOL = 1e-6
LAUNCH_SERVE_ARGV = ["--arch", LAUNCH_ARCH, "--batch", str(SERVE_BATCH),
                     "--prompt-len", str(SERVE_PROMPT), "--new-tokens", str(SERVE_NEW)]
# the dryrun phase: (a) the four kernels through their torch.library
# operators at the slice shapes, bit for bit against the wrappers called
# directly, and the host time a call of each; (b) launch/dryrun.py's
# prediction of full-width llama3.2-1b's bundle steps at 4 x 1024 at one
# rank (a fake group of one in a child process) beside the same steps run
# on the card: argument bytes equal, argument + temp bytes within 10% of
# max_memory_allocated; (c) the production dry run on fake CUDA DTensors in
# child processes (a fake group of 256): the dry run's command line for
# llama3.2-1b on the pod mesh, train's and serve's --dry-run
DRYRUN_ARCH = "llama3.2-1b"
DRYRUN_SHAPE = (SERVE_PROMPT, SERVE_BATCH)  # seq_len, global_batch
DRYRUN_KINDS = (("train_accum1", "train", 1), ("train_accum2", "train", 2),
                ("prefill", "prefill", None), ("decode", "decode", None))
DRYRUN_PEAK_GAP = 0.10  # |max_memory_allocated - (argument + temp)| / max_memory_allocated
DRYRUN_TIMED = 3  # timed steps of each kind, after one warm-up
HOST_CALLS = 30  # calls a host-time reading, launched back to back
DRYRUN_POD_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRYRUN_CHILD_LIMIT = 600  # seconds for the phase's child processes
# the prediction's child: dryrun.run_cell of each kind at 1 x 1 on a fake
# group of one, fake CUDA tensors; argv: arch, seq_len, batch, kinds, out
PREDICT_CHILD = """
import json, sys
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
arch, S, B, kinds, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
dryrun.fake_group(1)
mesh = make_test_mesh(1, 1)
recs = {name: dryrun.run_cell(arch, ShapeSpec(f"{kind}_{S}", S, B, kind), "1x1", mesh,
                              accum_steps=accum)
        for name, kind, accum in json.loads(kinds)}
with open(out, "w") as f:
    json.dump(recs, f)
"""


# ptxas -v lines: the entry a block of lines is about, its registers and spills
PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PTXAS_REGS = re.compile(r"Used (\d+) registers")
# the flash backward's passes: the mma route's (templated on type and padded
# head_dim) and the wgmma route's (bf16, templated on head_dim)
BWD_SYMBOL = re.compile(r"flash_bwd_(wgmma_)?(lse|dkdv|dq)_kernelI(f|13__nv_bfloat16)?Li(\d+)E")


# the SSD backward's passes: name and template arguments (csrc/ssd_scan_bwd.cu)
SSD_BWD_SYMBOL = re.compile(r"ssd_bwd_(\w+?)_kernel(?:I((?:Li\d+E)+)E)?")
SSD_BWD_TEMPLATE = {"scores": ("N",), "rev": ("P", "N"), "chunk": ("P",),
                    "inter": ("P", "N"), "dbc": ("P", "N")}


def ssd_bwd_ptxas(log: str) -> list[str]:
    """One line per SSD backward pass at the training shapes (P 64, N 64 and
    128 where templated) in nvcc's ``-Xptxas -v`` output: pass, template
    arguments, registers, spill bytes."""
    rows, entry, spill = [], None, ("?", "?")
    for line in log.splitlines():
        if m := PTXAS_ENTRY.search(line):
            entry, spill = None, ("?", "?")
            if sym := SSD_BWD_SYMBOL.search(m[1]):
                args = dict(zip(SSD_BWD_TEMPLATE.get(sym[1], ()),
                                map(int, re.findall(r"Li(\d+)E", sym[2] or ""))))
                if args.get("P", 64) == 64 and args.get("N", 64) in (64, 128):
                    entry = (sym[1], "".join(f" {k} {v}" for k, v in args.items()))
        elif m := PTXAS_SPILL.search(line):
            spill = (m[1], m[2])
        elif (m := PTXAS_REGS.search(line)) and entry:
            rows.append(f"ssd_bwd_{entry[0]}_kernel{entry[1]}: {m[1]} registers, "
                        f"spill stores {spill[0]} B, loads {spill[1]} B")
            entry = None
    return sorted(rows)


def bwd_pass(sym) -> str:
    """A backward pass's name, type and padded head_dim from a BWD_SYMBOL match."""
    return (f"flash_bwd_{sym[1] or ''}{sym[2]}_kernel {'f32' if sym[3] == 'f' else 'bf16'} "
            f"hd {sym[4]}")


def bwd_ptxas(log: str) -> list[str]:
    """One line per instance of the backward's passes in nvcc's ``-Xptxas
    -v`` output: pass, type, padded head_dim, registers, spill bytes; and a
    line for each pass whose wgmma ptxas serialises (C7518)."""
    rows, entry, spill = [], None, ("?", "?")
    for line in log.splitlines():
        if "(C75" in line and (sym := BWD_SYMBOL.search(line)):
            rows.append(f"{bwd_pass(sym)}: {line[line.index('(C75'):].split(' in the function')[0]}")
        elif m := PTXAS_ENTRY.search(line):
            entry, spill = BWD_SYMBOL.search(m[1]), ("?", "?")
        elif m := PTXAS_SPILL.search(line):
            spill = (m[1], m[2])
        elif (m := PTXAS_REGS.search(line)) and entry:
            rows.append(f"{bwd_pass(entry)}: {m[1]} registers, "
                        f"spill stores {spill[0]} B, loads {spill[1]} B")
            entry = None
    return sorted(rows)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


PHASE_STARTS: list = []  # (name, perf_counter at its start) of each phase


def phase(name: str) -> None:
    PHASE_STARTS.append((name, time.perf_counter()))
    print(f"== {name}", flush=True)


def roofline(flops: float, nbytes: int, f32: bool):
    """(bound_ms, bound_by, flops, bytes, terms): the larger of ``nbytes``
    over HBM bandwidth and ``flops`` over the peak rate of the inputs' type.
    f32 takes the faster of two routes that keep f32 accuracy, as
    ``ssd_bound`` does: the f32 CUDA cores, or the TF32 tensor cores at three
    products each (3xTF32; one TF32 product misses the f32 tolerance).
    ``terms`` holds each time in ms."""
    if f32:
        terms = {"f32_ms": flops / PEAK_FLOPS["float32"] * 1e3,
                 "3xtf32_ms": 3 * flops / PEAK_FLOPS["tf32"] * 1e3}
    else:
        terms = {"bf16_ms": flops / PEAK_FLOPS["bfloat16"] * 1e3}
    t_ops = min(terms.values())
    terms["bytes_ms"] = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, terms["bytes_ms"]),
            "operations" if t_ops >= terms["bytes_ms"] else "bytes", flops, nbytes, terms)


def attention_bound(q, k, v, causal, window):
    """The forward's bound (``roofline``): its two products over the visible
    (q, k) pairs; q, k and v read once, the output written once."""
    from repro_torch.kernels.flash_attention import flops as attention_flops

    flops = attention_flops(q.shape, k.shape, causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return roofline(flops, nbytes, q.element_size() == 4)


def attention_bwd_bound(q, k, causal, window):
    """The backward's bound (``roofline``): its five products (dV = P^T dO,
    dP = dO V^T, S = Q K^T recomputed, dQ = dS K, dK = dS^T Q), 2.5x the
    forward's, over the visible pairs; q, k, v, o and dO read once, dq, dk
    and dv written once."""
    from repro_torch.kernels.flash_attention import flops as attention_flops

    flops = attention_flops(q.shape, k.shape, causal, window, backward=True)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    return roofline(flops, nbytes, q.element_size() == 4)


def bound_terms(terms: dict) -> str:
    return ", ".join(f"{key.removesuffix('_ms')} {ms * 1e3:.2f} us" for key, ms in terms.items())


def attention_inputs(torch, gen, dev, shape, dt, T=None):
    """q [B, S, H, hd], k and v [B, T, KV, hd] (T = S unless given) of type
    ``dt``, and their [B, heads, S or T, hd] copies for SDPA."""
    B, S, H, KV, hd = shape
    T = T or S
    qkv = [torch.randn(s, generator=gen, device=dev).to(getattr(torch, dt))
           for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]
    return qkv, [x.transpose(1, 2).contiguous() for x in qkv]


def ssd_bound(xh, Bm, chunk: int):
    """(bound_ms, bound_by, flops, bytes, terms) of the SSD scan as prefill
    calls it (with the final state). The operations are the chunked scan's
    products (``kernels/ssd_scan.py:flops``). They take the faster of two routes that
    keep f32 accuracy: the f32 CUDA cores, or the TF32 tensor cores at three
    products each (3xTF32: hi*hi' + hi*lo' + lo*hi'; one TF32 product misses
    the scan's 1e-4). Bytes over HBM bandwidth: each input read once, y and
    the final state written once. ``terms`` holds the three times in ms."""
    from repro_torch.kernels.ssd_scan import flops as scan_flops

    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    flops = scan_flops(xh.shape, N, chunk)
    nbytes = (2 * xh.numel() + B * S * H + H + 2 * Bm.numel() + B * H * P * N) * 4
    terms = {"f32_ms": flops / PEAK_FLOPS["float32"] * 1e3,
             "3xtf32_ms": 3 * flops / PEAK_FLOPS["tf32"] * 1e3,
             "bytes_ms": nbytes / PEAK_BYTES * 1e3}
    t_ops = min(terms["f32_ms"], terms["3xtf32_ms"])
    return (max(t_ops, terms["bytes_ms"]),
            "operations" if t_ops >= terms["bytes_ms"] else "bytes", flops, nbytes, terms)


def ssd_bwd_bound(xh, Bm, chunk: int):
    """(bound_ms, bound_by, flops, bytes, terms) of the SSD backward, as
    ``ssd_bound``. The operations: the backward's products
    (``kernels/ssd_scan.py:flops``). Bytes: xh, dt, A, Bm, Cm and dy
    read once; dxh, ddt, dA, dBm and dCm written once."""
    from repro_torch.kernels.ssd_scan import flops as scan_flops

    B, S, H, P = xh.shape
    flops = scan_flops(xh.shape, Bm.shape[-1], chunk, backward=True)
    nbytes = (3 * xh.numel() + 2 * B * S * H + 2 * H + 4 * Bm.numel()) * 4
    terms = {"f32_ms": flops / PEAK_FLOPS["float32"] * 1e3,
             "3xtf32_ms": 3 * flops / PEAK_FLOPS["tf32"] * 1e3,
             "bytes_ms": nbytes / PEAK_BYTES * 1e3}
    t_ops = min(terms["f32_ms"], terms["3xtf32_ms"])
    return (max(t_ops, terms["bytes_ms"]),
            "operations" if t_ops >= terms["bytes_ms"] else "bytes", flops, nbytes, terms)


def ssd_inputs(torch, gen, dev, B, S, H, P, N, slow=False):
    """Inputs as ssd_block gives them: dt after softplus (scaled by 0.02 with
    ``slow``), A < 0."""
    xh = torch.randn((B, S, H, P), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    if slow:
        dt = 0.02 * dt
    A = -torch.exp(0.3 * torch.randn((H,), generator=gen, device=dev))
    Bm = 0.5 * torch.randn((B, S, N), generator=gen, device=dev)
    Cm = 0.5 * torch.randn((B, S, N), generator=gen, device=dev)
    return xh, dt, A, Bm, Cm


def time_ms(torch, fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back launches (CUDA events),
    after two warm-up calls."""
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_turns(torch, fns: dict) -> dict:
    """Median ms of each function over three rounds in turns, so drift hits
    all alike: ``fns`` maps a name to (function, launches a round)."""
    got = {name: [] for name in fns}
    for _ in range(3):
        for name, (fn, reps) in fns.items():
            got[name].append(time_ms(torch, fn, reps))
    return {name: statistics.median(vals) for name, vals in got.items()}


def time_pair(torch, fns: dict, reps: int) -> dict:
    """``time_turns`` at ``reps`` launches a round for every function."""
    return time_turns(torch, {name: (fn, reps) for name, fn in fns.items()})


def compare(got, want, tol: float) -> tuple[float, bool]:
    """(max abs error, whether |got - want| <= tol + tol * |want| everywhere
    and got is finite): allclose with rtol = atol = tol."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return float(diff.max()), ok


def compare_scaled(got, want, tol: float) -> tuple[float, bool]:
    """(max abs error, whether max |got - want| <= tol * max |want| and got
    is finite): a tolerance scaled by the largest element."""
    diff = float((got.float() - want.float()).abs().max())
    ok = diff <= tol * float(want.float().abs().max()) and bool(got.isfinite().all())
    return diff, ok


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def exec_reference(kind: str, group, x):
    """The conformance suite's plain numpy reference of a stacked
    collective (tests/_exec_harness.py:reference): zeros off the group."""
    import numpy as np

    gl = list(group)
    if kind == "all_gather":
        out = np.zeros((x.shape[0], len(gl)) + x.shape[1:], x.dtype)
        out[gl] = x[gl]
    elif kind == "reduce_scatter":
        out = np.zeros((x.shape[0],) + x.shape[2:], x.dtype)
        for i, d in enumerate(gl):
            out[d] = x[gl, i].sum(axis=0)
    elif kind == "all_reduce":
        out = np.zeros_like(x)
        out[gl] = x[gl].sum(axis=0)
    else:
        out = np.zeros((x.shape[0], len(gl)) + x.shape[2:], x.dtype)
        for i, d in enumerate(gl):
            out[d] = x[gl, i]
    return out


def executor_bytes(plan, chunk_bytes: int) -> int:
    """Bytes the stacked executor's rounds move: per send, the gather of the
    sent chunk (read, write) and its write at the receiver (copy: read,
    write; reduce: read, read, write); per non-receiver, the zeros written
    to its trash slot."""
    total = 0
    for rt in plan.rounds:
        dst = [d for _, d in rt.perm]
        reduce = int(rt.is_reduce[dst].sum()) if dst else 0
        total += (2 * len(dst) + 2 * (len(dst) - reduce) + 3 * reduce
                  + int((~rt.is_recv).sum())) * chunk_bytes
    return total


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return tree.numel()


def check_all_reduce(torch, x, topo, req, label: str, program=None):
    """Run ``req``'s all-reduce once on the stacked rows ``x`` (through
    ``program`` when one is given), then: a column sample of every chunk
    bit for bit against the numpy interpreter, the group's rows within
    EXEC_TOL of the group's sum, every other row exact zeros. Returns the
    output."""
    import numpy as np

    from repro_torch.comms import primitives

    group = tuple(req.group)
    out = primitives.pccl_all_reduce(x, topo, req, program=program)
    L = x.shape[1] // len(group)
    cols = np.sort(np.random.default_rng(2).choice(L, SAMPLE_COLS, replace=False))
    idx = torch.from_numpy((np.arange(len(group))[:, None] * L + cols).reshape(-1)).to(x.device)
    x_s = x.index_select(1, idx).cpu().numpy()
    got_s = out.index_select(1, idx).cpu().numpy()
    interp = primitives.interpret_collective("all_reduce", x_s, topo, req, program=program)
    if not np.array_equal(got_s.view(np.uint32), interp.view(np.uint32)):
        fail(f"{label}: the card's result differs from the numpy interpreter on "
             f"the column sample")
    total = x[group[0]].clone()  # x[group].sum(0) without a copy of x[group]
    for d in group[1:]:
        total += x[d]
    err = 0.0
    for d in range(x.shape[0]):
        if d in group:
            diff = (out[d] - total).abs()
            err = max(err, float(diff.max()))
            if not bool((diff <= EXEC_TOL + EXEC_TOL * total.abs()).all()):
                fail(f"{label}: rank {d} misses x[group].sum(0) (max abs err {err:.3g})")
        elif bool(out[d].view(torch.int32).any()):
            fail(f"{label}: rank {d} is outside the group and was not left at zero")
    print(f"  {label}: bit-equal to the numpy interpreter on {SAMPLE_COLS} columns of "
          f"each of {len(group)} chunks; max abs err vs x[group].sum(0) {err:.3g} "
          f"(tol {EXEC_TOL}); ranks outside the group exact zeros")
    del total
    return out


def collective_phase(torch, dev, get_config, LM) -> int:
    """The executor's selftest, the fig_exec routes and the all-reduce of
    mamba2-370m's gradient vector, on the stacked backend on the card.
    Returns the vector's length a rank."""
    import numpy as np

    from repro_torch.comms import executor, primitives, selftest
    from repro_torch.core import CollectiveRequest
    from repro_torch.launch import trace
    from repro_torch.topology import ring
    from repro_torch.topology.generators import grid_hypercube, multi_pod

    phase("collectives")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    selftest.main([])

    fabrics = {"ring8": ring(8, bidirectional=True), "grid23": grid_hypercube(2, 3),
               "mp222": multi_pod(2, 2, 2, unit_links=True, dci_ports_per_pod=2)}
    n = EXEC_RANKS
    for tag, (fabric, kind, kw, rounds, sends) in FIG_EXEC.items():
        topo = fabrics[fabric]
        req = CollectiveRequest(kind, group=tuple(range(n)), **kw)
        prog, plan = primitives.synthesize_program(topo, req)
        if (prog.num_rounds, prog.num_sends) != (rounds, sends):
            fail(f"{tag}: {prog.num_rounds} rounds and {prog.num_sends} sends, "
                 f"want {rounds} and {sends} (BENCH_synthesis.json)")
        rng = np.random.default_rng(42)
        shape = {"all_gather": (n, EXEC_PAYLOAD),
                 "all_reduce": (n, n * EXEC_PAYLOAD)}.get(kind, (n, n, EXEC_PAYLOAD))
        x = rng.standard_normal(shape).astype(np.float32)
        fn = getattr(primitives, f"pccl_{kind}")
        xd = torch.from_numpy(x).to(dev)
        got = fn(xd, topo, req).cpu().numpy()
        interp = primitives.interpret_collective(kind, x, topo, req)
        if not np.array_equal(got.view(np.uint32), interp.view(np.uint32)):
            fail(f"{tag}: the card's result differs from the numpy round interpreter")
        want = exec_reference(kind, range(n), x)
        err = float(np.abs(got - want).max())
        exact = kind in ("all_gather", "all_to_all")
        if not (np.array_equal(got, want) if exact else
                np.allclose(got, want, rtol=EXEC_TOL, atol=EXEC_TOL)):
            fail(f"{tag}: the result misses the plain reference (max abs err {err:.3g})")
        ms = statistics.median(time_ms(torch, lambda: fn(xd, topo, req), 20) for _ in range(3))
        print(f"  {tag}: {prog.num_rounds} rounds, {prog.num_sends} sends, "
              f"{plan.buffer_slots} slots a rank; bit-equal to the numpy interpreter; "
              f"max abs err vs the plain reference {err:.3g} "
              f"({'exact' if exact else f'tol {EXEC_TOL}'}); {ms:.4f} ms a call")

    # the f32 gradient vector of an 8-rank data-parallel mamba2-370m step:
    # every parameter and the loss, padded to a multiple of the ranks
    cfg = get_config("mamba2-370m")
    params = LM(cfg, device=dev).init(0)
    nparams = count_params(params)
    del params
    D = -(-(nparams + 1) // n) * n
    topo = fabrics["ring8"]
    req = CollectiveRequest("all_reduce", group=tuple(range(n)))
    prog, plan = primitives.synthesize_program(topo, req)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((n, D), generator=gen, device=dev)
    print(f"  mamba2-370m: {nparams} parameters + the loss -> D = {D} f32 "
          f"({D * 4 / 1e9:.3f} GB a rank, {n} ranks in one tensor)")

    check_all_reduce(torch, x, topo, req, "all-reduce, 8 of 8 ranks")
    # one call under the profiler: its kernels and where their time goes
    # (trace.traced raises if the profiler sees no kernel on the card)
    traced = trace.traced(lambda: primitives.pccl_all_reduce(x, topo, req), dev)
    launches = traced["launches"]
    print(f"  all-reduce traced: wall {traced['wall_us'] / 1e3:.3f} ms, device busy "
          f"{traced['busy_us'] / 1e3:.3f} ms (idle {1 - traced['busy_us'] / traced['wall_us']:.1%}), "
          f"{launches} kernels; by kernel:")
    for name, us in sorted(traced["by_name"].items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / 1e3:9.3f} ms  {name[:110]}")
    timed = {"pccl": lambda: primitives.pccl_all_reduce(x, topo, req),
             "sum": lambda: x.sum(0)}
    got = {name: [] for name in timed}
    for _ in range(3):  # in turns
        for name, fn in timed.items():
            got[name].append(time_ms(torch, fn, 3))
    got = {name: statistics.median(v) for name, v in got.items()}
    chunk_bytes = D // n * 4
    rounds_bytes = executor_bytes(plan, chunk_bytes)
    # the call beside its rounds: zeros for the buffer, the input put in
    # (read, write), the output gathered (read, write) and masked (read, write)
    call_bytes = rounds_bytes + (n * plan.buffer_slots + 6 * n * n) * chunk_bytes
    io_bytes = 2 * n * D * 4  # the function's bound: x read once, the output written once
    print(f"  all-reduce over ring(8, bidirectional): {prog.num_rounds} rounds, "
          f"{prog.num_sends} sends, {plan.buffer_slots} slots a rank, {launches} kernels "
          f"a call")
    print(f"  all-reduce: {got['pccl']:.3f} ms a call (median of 3 rounds of 3, CUDA "
          f"events); x.sum(0) {got['sum']:.3f} ms; the rounds move {rounds_bytes / 1e9:.3f} GB "
          f"({rounds_bytes / PEAK_BYTES * 1e3:.3f} ms at {PEAK_BYTES / 1e12:.2f} TB/s), the "
          f"call {call_bytes / 1e9:.3f} GB ({call_bytes / PEAK_BYTES * 1e3:.3f} ms); bound "
          f"{io_bytes / PEAK_BYTES * 1e3:.3f} ms by bytes ({io_bytes / 1e9:.3f} GB in and out); "
          f"the call at {got['pccl'] / (io_bytes / PEAK_BYTES * 1e3):.2f}x its bound, "
          f"{call_bytes / got['pccl'] / 1e9:.3f} TB/s of modelled traffic")
    # a strict subgroup: the same memory, rows of a length the 5 chunks divide
    D5 = D - D % len(SUBGROUP)
    check_all_reduce(torch, x.view(-1)[:n * D5].view(n, D5), topo,
                     CollectiveRequest("all_reduce", group=SUBGROUP),
                     f"all-reduce, subgroup {SUBGROUP} of 8 ranks")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"collectives: all_reduce_ms={got['pccl']:.3f} sum_ms={got['sum']:.3f} "
          f"rounds_bytes={rounds_bytes} call_bytes={call_bytes} "
          f"bound_ms={io_bytes / PEAK_BYTES * 1e3:.3f} launches={launches} "
          f"max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB)")
    del x, timed
    executor.clear_plan_cache()
    torch.cuda.empty_cache()
    return D


def first_internal_link(topo, pod: int) -> int:
    """The first non-boundary link with both ends in ``pod``
    (benchmarks/repair.py:_first_internal_link)."""
    members = set(topo.pods()[pod])
    boundary = {link.id for link in topo.boundary_links()}
    return next(link.id for link in topo.links
                if link.id not in boundary and link.src in members and link.dst in members)


def fig_repair(core, topology, shape) -> dict:
    """benchmarks/repair.py:_scenario through one planner package, given as
    its ``core`` and ``topology`` modules: plan the all-gather over every
    NPU of ``three_level(*shape)`` in the sequential regime, repair it
    against pod 0's first internal link (timed, unvalidated, as the bench
    times it), then synthesize it cold on a fresh fabric's degraded view
    with a fresh registry (timed). Both plans are validated after, untimed."""
    topo = topology.three_level(*shape, unit_links=True)
    req = core.CollectiveRequest("all_gather", group=tuple(topo.npus))
    event = core.DegradationEvent(failed_links=[first_internal_link(topo, 0)])
    rp = core.PlanRepairer(topo, registry=core.AlgorithmRegistry(), pipeline=False)
    t0 = time.perf_counter()
    rp.plan(req)
    t1 = time.perf_counter()
    res = rp.repair(req, event, validate=None)
    t2 = time.perf_counter()
    cold_view = topology.three_level(*shape, unit_links=True).degraded(
        event.failed_links, event.failed_npus)
    t3 = time.perf_counter()
    cold = core.SynthesisEngine(cold_view.topology,
                                registry=core.AlgorithmRegistry()).collective(req)
    t4 = time.perf_counter()
    res.algorithm.validate()
    cold.validate()
    return {"res": res, "cold": cold, "cold_view": cold_view, "plan_s": t1 - t0,
            "repair_s": t2 - t1, "cold_s": t4 - t3}


def repair_properties(res, cold) -> tuple:
    """A fig_repair row's gated properties, in FIG_REPAIR's order."""
    alg = res.algorithm
    return (res.strategy, res.phases_kept, res.phases_resynthesized, float(alg.makespan),
            alg.num_transfers, float(cold.makespan))


def repair_all_reduce_cases(core, topology) -> dict:
    """The all-reduces the phase repairs at the real size: label -> (fabric,
    event). The ring is the data-parallel ring that GradientMean plans;
    mp222 is FIG_EXEC's multi-pod fabric."""
    def mp222():
        return topology.multi_pod(2, 2, 2, unit_links=True, dci_ports_per_pod=2)

    link, npu = mp222(), mp222()
    dead = next(n for n in npu.pods()[0] if n not in npu.gateways(0))
    return {
        "ring8, link 0 failed": (topology.ring(8, bidirectional=True),
                                 core.DegradationEvent(failed_links=[0])),
        f"mp222, pod-internal link {first_internal_link(link, 0)} failed": (
            link, core.DegradationEvent(failed_links=[first_internal_link(link, 0)])),
        f"mp222, NPU {dead} failed": (npu, core.DegradationEvent(failed_npus=[dead])),
    }


def boundary_cut(core, topology) -> tuple:
    """mp222 with every boundary link cut (tests/test_repair.py:222): no
    schedule can join its pods. (fabric, event)."""
    topo = topology.multi_pod(2, 2, 2, unit_links=True, dci_ports_per_pod=2)
    return topo, core.DegradationEvent(failed_links=[link.id for link in topo.boundary_links()])


def repair_all_reduce(core, svc, topo, event) -> tuple:
    """Plan the all-reduce over every NPU of ``topo`` through ``svc``'s
    repairer, then repair it through ``svc.repair``: (the healthy plan, the
    RepairResult). FabricDegradedError where no schedule can survive."""
    req = core.CollectiveRequest("all_reduce", group=tuple(topo.npus))
    healthy = svc.repairer(topo).plan(req)
    return healthy, svc.repair(topo, req, event)


def seed_60973(core, topology) -> tuple:
    """tests/test_repair_property.py's check_repair_seed(60973): a
    reduce_scatter over three_level(2, 2, 2) planned in the sequential
    regime, then SEED_60973_EVENT. (the repairer, the request, the event)."""
    topo = topology.three_level(2, 2, 2, unit_links=True)
    req = core.CollectiveRequest("reduce_scatter", group=tuple(topo.npus))
    rp = core.PlanRepairer(topo, registry=core.AlgorithmRegistry(), pipeline=False)
    rp.plan(req)
    return rp, req, core.DegradationEvent(**SEED_60973_EVENT)


def failed_parts_used(alg, view, event) -> list[str]:
    """The failed links that a plan on a degraded view sends over, its link
    ids mapped back through ``view.links`` (the view keeps node ids), and
    the failed NPUs it sends from or to."""
    import numpy as np

    links = set(np.asarray(view.links)[alg.columns.link].tolist())
    nodes = set(alg.columns.src.tolist()) | set(alg.columns.dst.tolist())
    return ([f"link {x}" for x in sorted(links & set(event.failed_links))]
            + [f"NPU {x}" for x in sorted(nodes & set(event.failed_npus))])


def plan_repair_phase(torch, dev, D: int) -> None:
    """Repaired plans on the stacked backend on the card, beside the plans
    they replace: (a) fig_repair_64's repaired and cold all-gathers, (b)
    repaired all-reduces of mamba2-370m's gradient vector (D f32 a rank, 8
    ranks), (c) the reference's repair fault at check_repair_seed(60973),
    fixed in the copy, (d) a repair that must refuse, (e) fig_repair_512."""
    import math

    import numpy as np

    import repro_torch.core as core
    import repro_torch.topology as topology
    from repro_torch.comms import executor, primitives
    from repro_torch.launch import trace

    phase("plan repair")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    summary = []

    def avoids_failures(label, alg, view, event):
        if used := failed_parts_used(alg, view, event):
            fail(f"{label}: the plan sends over the failed {', '.join(used)}")

    # (a) fig_repair_64: the repaired and the cold all-gather ---------------
    shape, want = FIG_REPAIR["fig_repair_64"]
    got = fig_repair(core, topology, shape)
    res, cold = got["res"], got["cold"]
    props = repair_properties(res, cold)
    if props != want:
        fail(f"fig_repair_64: strategy, kept, resynth, makespan, transfers, cold makespan "
             f"{props}, want {want} (BENCH_synthesis.json)")
    print(f"  fig_repair_64: three_level{shape}, all-gather of {len(res.request.group)} "
          f"NPUs, link {res.event.failed_links[0]} failed: strategy {props[0]}, kept "
          f"{props[1]}, resynth {props[2]}, makespan {props[3]:g} (cold {props[5]:g}), "
          f"{props[4]} transfers, as BENCH_synthesis.json's row; repair "
          f"{got['repair_s'] * 1e3:.1f} ms, cold synthesis {got['cold_s'] * 1e3:.1f} ms "
          f"on the host")
    n = len(res.request.group)
    x = np.random.default_rng(3).standard_normal((n, EXEC_PAYLOAD)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    want_out = exec_reference("all_gather", range(n), x)
    progs = {}
    for name, alg, view in (("repaired", res.algorithm, res.view),
                            ("cold", cold, got["cold_view"])):
        avoids_failures(f"fig_repair_64 {name}", alg, view, res.event)
        progs[name] = primitives.lower_algorithm(alg, key=f"fig_repair_64 {name}")
        out = primitives.pccl_all_gather(xd, None, res.request, program=progs[name])
        out = out.cpu().numpy()
        interp = primitives.interpret_collective("all_gather", x, None, res.request,
                                                 program=progs[name])
        if not np.array_equal(out.view(np.uint32), interp.view(np.uint32)):
            fail(f"fig_repair_64 {name}: the card's result differs from the numpy interpreter")
        if not np.array_equal(out, want_out):
            fail(f"fig_repair_64 {name}: the result differs from the plain gather")
    del out, interp, want_out
    ms = time_pair(torch, {name: (lambda prog=prog: primitives.pccl_all_gather(
        xd, None, res.request, program=prog)) for name, prog in progs.items()}, 10)
    for name, (prog, plan) in progs.items():
        print(f"  fig_repair_64 {name}: {prog.num_rounds} rounds, {prog.num_sends} sends, "
              f"{plan.buffer_slots} slots a rank; {EXEC_PAYLOAD} f32 a shard "
              f"({n * n * EXEC_PAYLOAD * 4 / 1e6:.1f} MB out); bit-equal to the numpy "
              f"interpreter and exactly the plain gather; no transfer on the failed link; "
              f"{ms[name]:.4f} ms a call (median of 3 rounds of 10, CUDA events, in turns)")
        summary.append(f"fig_repair_64 {name} {prog.num_rounds}/{prog.num_sends}/"
                       f"{ms[name]:.3f}")
    traced = trace.traced(lambda: primitives.pccl_all_gather(
        xd, None, res.request, program=progs["repaired"]), dev)
    print(f"  fig_repair_64 repaired traced: wall {traced['wall_us'] / 1e3:.3f} ms, device "
          f"busy {traced['busy_us'] / 1e3:.3f} ms (idle "
          f"{1 - traced['busy_us'] / traced['wall_us']:.1%}), {traced['launches']} kernels; "
          f"by kernel:")
    for name, us in sorted(traced["by_name"].items(), key=lambda kv: -kv[1])[:4]:
        print(f"    {us / 1e3:9.3f} ms  {name[:110]}")
    del xd, progs
    executor.clear_plan_cache()

    # (b) repaired all-reduces of the gradient vector -----------------------
    n = EXEC_RANKS
    gen = torch.Generator(device=dev).manual_seed(4)
    for label, (topo, event) in repair_all_reduce_cases(core, topology).items():
        svc = core.PlanService(registry=core.AlgorithmRegistry())
        healthy, res = repair_all_reduce(core, svc, topo, event)
        avoids_failures(label, res.algorithm, res.view, event)
        group = res.request.group
        # rows every plan's chunks divide: D itself unless a rank died
        W = D - D % math.lcm(len(group), n)
        x = torch.randn((n, W), generator=gen, device=dev)
        dead = [d for d in range(n) if d not in group]
        x[dead] = float("nan")
        prog = primitives.lower_algorithm(res.algorithm, key=label)
        out = check_all_reduce(torch, x, None, res.request, f"{label}, repaired",
                               program=prog)
        if not bool(torch.isfinite(out).all()):
            fail(f"{label}: the output is not finite")
        del out
        full = core.CollectiveRequest("all_reduce", group=tuple(topo.npus))
        undamaged = primitives.lower_algorithm(healthy, key=f"{label} undamaged")
        ms = time_pair(torch, {
            "repaired": lambda: primitives.pccl_all_reduce(x, None, res.request, program=prog),
            "undamaged": lambda: primitives.pccl_all_reduce(x, None, full,
                                                            program=undamaged)}, 3)
        print(f"  {label}: strategy {res.strategy} (kept {res.phases_kept}, resynth "
              f"{res.phases_resynthesized}), group {group}; {W} f32 a rank"
              f"{f', NPU {dead} NaN in, exact zeros out, every row finite' if dead else ''}; "
              f"repaired {prog[0].num_rounds} rounds, {prog[0].num_sends} sends, "
              f"{ms['repaired']:.3f} ms a call; undamaged {undamaged[0].num_rounds} rounds, "
              f"{undamaged[0].num_sends} sends, {ms['undamaged']:.3f} ms (median of 3 rounds "
              f"of 3, CUDA events, in turns); no transfer on a failed link or NPU; repair "
              f"metrics {({k: v for k, v in svc.metrics().items() if k.startswith('repair')})}")
        summary.append(f"{label.split(',')[0]} {'npu' if dead else 'link'} "
                       f"{prog[0].num_rounds}/{prog[0].num_sends}/{ms['repaired']:.3f} "
                       f"(undamaged {undamaged[0].num_rounds}/{undamaged[0].num_sends}/"
                       f"{ms['undamaged']:.3f})")
        del x, prog, undamaged
        executor.clear_plan_cache()
        torch.cuda.empty_cache()

    # (c) the reference's repair fault, fixed in the copy -------------------
    rp, req, event = seed_60973(core, topology)
    try:
        res = rp.repair(req, event)
    except core.FabricDegradedError as e:
        fail(f"check_repair_seed(60973): the copy refused ({e}); tests/test_torch_repair.py "
             f"pins a plan there")
    res.algorithm.validate(mode="oracle")
    avoids_failures("seed 60973", res.algorithm, res.view, event)
    group = res.request.group
    prog = primitives.lower_algorithm(res.algorithm, key="seed 60973")
    x = np.random.default_rng(5).standard_normal(
        (prog[1].num_devices, len(group), EXEC_PAYLOAD)).astype(np.float32)
    out = primitives.pccl_reduce_scatter(torch.from_numpy(x).to(dev), None, res.request,
                                         program=prog).cpu().numpy()
    interp = primitives.interpret_collective("reduce_scatter", x, None, res.request,
                                             program=prog)
    if not np.array_equal(out.view(np.uint32), interp.view(np.uint32)):
        fail("seed 60973: the card's result differs from the numpy interpreter")
    want_out = exec_reference("reduce_scatter", group, x)
    err = float(np.abs(out - want_out).max())
    if not np.allclose(out, want_out, rtol=EXEC_TOL, atol=EXEC_TOL):
        fail(f"seed 60973: the result misses the plain sum (max abs err {err:.3g})")
    print(f"  check_repair_seed(60973): three_level(2, 2, 2), reduce_scatter, "
          f"{SEED_60973_EVENT} (the reference's repair stops here on a bare AssertionError, "
          f"pinned by tests/test_torch_repair.py): the copy returns a {res.strategy} plan over group {group}, {prog[0].num_rounds} rounds, "
          f"{prog[0].num_sends} sends, oracle-valid, bit-equal to the numpy interpreter on "
          f"the card, max abs err vs the plain sum {err:.3g} (tol {EXEC_TOL})")
    summary.append(f"seed60973 {prog[0].num_rounds}/{prog[0].num_sends}")

    # (d) the loud failure --------------------------------------------------
    svc = core.PlanService(registry=core.AlgorithmRegistry())
    topo, event = boundary_cut(core, topology)
    try:
        repair_all_reduce(core, svc, topo, event)
        fail("mp222 with every boundary link cut: the repair returned a plan")
    except core.FabricDegradedError as e:
        refused = str(e)
    if svc.metrics()["repair_failures"] != 1:
        fail(f"mp222 cut: repair_failures {svc.metrics()['repair_failures']}, want 1")
    print(f"  mp222, all {len(event.failed_links)} boundary links cut: FabricDegradedError "
          f"({refused}); repair_failures 1")

    # (e) fig_repair_512 ----------------------------------------------------
    shape, want = FIG_REPAIR["fig_repair_512"]
    got = fig_repair(core, topology, shape)
    res = got["res"]
    props = repair_properties(res, got["cold"])
    if props != want:
        fail(f"fig_repair_512: strategy, kept, resynth, makespan, transfers, cold makespan "
             f"{props}, want {want} (BENCH_synthesis.json)")
    avoids_failures("fig_repair_512", res.algorithm, res.view, res.event)
    t0 = time.perf_counter()
    prog = primitives.lower_algorithm(res.algorithm, key="fig_repair_512")
    t1 = time.perf_counter()
    n = len(res.request.group)
    x = np.random.default_rng(6).standard_normal((n, REPAIR_SCALE_PAYLOAD)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    out = primitives.pccl_all_gather(xd, None, res.request, program=prog).cpu().numpy()
    interp = primitives.interpret_collective("all_gather", x, None, res.request, program=prog)
    if not np.array_equal(out.view(np.uint32), interp.view(np.uint32)):
        fail("fig_repair_512: the card's result differs from the numpy interpreter")
    if not np.array_equal(out, exec_reference("all_gather", range(n), x)):
        fail("fig_repair_512: the result differs from the plain gather")
    t2 = time.perf_counter()
    del out, interp
    ms512 = statistics.median(time_ms(torch, lambda: primitives.pccl_all_gather(
        xd, None, res.request, program=prog), 2) for _ in range(3))
    print(f"  fig_repair_512: three_level{shape}, {n} NPUs: strategy {props[0]}, kept "
          f"{props[1]}, resynth {props[2]}, makespan {props[3]:g} (cold {props[5]:g}), "
          f"{props[4]} transfers, as BENCH_synthesis.json's row; on the host: plan "
          f"{got['plan_s']:.3f} s, repair {got['repair_s']:.3f} s, cold synthesis "
          f"{got['cold_s']:.3f} s, lowering {t1 - t0:.3f} s; {prog[0].num_rounds} rounds, "
          f"{prog[0].num_sends} sends, {prog[1].buffer_slots} slots a rank; "
          f"{REPAIR_SCALE_PAYLOAD} f32 a shard ({n * n * REPAIR_SCALE_PAYLOAD * 4 / 1e6:.1f} "
          f"MB out) bit-equal to the numpy interpreter and exactly the plain gather "
          f"(one call and both checks {t2 - t1:.3f} s); {ms512:.3f} ms a call")
    summary.append(f"fig_repair_512 {prog[0].num_rounds}/{prog[0].num_sends}/{ms512:.3f}")
    del xd, prog
    executor.clear_plan_cache()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated(dev)
    print("plan_repair: rounds/sends/ms " + "; ".join(summary)
          + f"; max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB); "
          f"{time.perf_counter() - t_phase:.1f} s")


def switch_peaks(alg) -> dict:
    """Each limited switch's peak occupancy in ``alg``, counted as
    ``validate()`` counts it: a residency per (switch, chunk) from its first
    arrival to its last forward, a departure leaving before a same-instant
    arrival."""
    topo = alg.topology
    arrive, depart = {}, {}
    for t in alg.transfers:
        if topo.is_switch(t.src):
            depart[(t.src, t.chunk)] = max(depart.get((t.src, t.chunk), 0.0), t.end)
        if topo.is_switch(t.dst):
            arrive.setdefault((t.dst, t.chunk), t.end)
    events = {}
    for (sw, c), a in arrive.items():
        events.setdefault(sw, []).extend(((a, 1), (max(depart.get((sw, c), a), a), -1)))
    peaks = {}
    for sw, evs in sorted(events.items()):
        if topo.nodes[sw].buffer_limit is not None:
            occ = peak = 0
            for _, delta in sorted(evs):
                occ += delta
                peak = max(peak, occ)
            peaks[sw] = peak
    return peaks


def switch_fault(alg):
    """``alg`` with one arrival shifted into a full buffer: of a limited
    switch's two earliest residencies, the later one's arrival moved to end
    at the earlier one's, over the same link, which nothing else uses then."""
    import repro_torch.core as core

    topo = alg.topology
    ts = list(alg.transfers)
    into = sorted((k for k, t in enumerate(ts) if topo.is_switch(t.dst)
                   and topo.nodes[t.dst].buffer_limit == 1), key=lambda k: (ts[k].end, k))
    first = ts[into[0]]
    k = next(k for k in into if ts[k].dst == first.dst and ts[k].end > first.end
             and ts[k].chunk != first.chunk)
    moved = dataclasses.replace(ts[k], start=ts[k].start - (ts[k].end - first.end),
                                end=first.end)
    if moved.start < 0 or any(moved.overlaps(t) for j, t in enumerate(ts)
                              if t.link == moved.link and j != k):
        fail("switch buffers: the planted arrival has no free slot on its link")
    transfers = ts[:k] + [moved] + ts[k + 1:]
    return core.CollectiveAlgorithm(topo, alg.conditions, transfers, name=alg.name)


def switch_buffers_phase(torch, dev, smi_line: str) -> None:
    """Plans over limited switch buffers, synthesized by the planner copy
    and run on the stacked backend on the card: SWITCH_FABRICS x
    SWITCH_KINDS, a planted buffer fault, and threads sharing a topology."""
    import threading

    import numpy as np

    import repro_torch.core as core
    import repro_torch.topology as topology
    from repro_torch.comms import executor, primitives

    phase("switch buffers")
    t_phase = time.perf_counter()
    n = EXEC_RANKS
    rows = []
    for label, (gen_name, args, limit) in SWITCH_FABRICS.items():
        for kind, pipelined in SWITCH_KINDS:
            case = f"{label} {kind}{' pipelined' if pipelined else ''}"
            topo = getattr(topology, gen_name)(*args, buffer_limit=limit)
            req = core.CollectiveRequest(kind, group=tuple(topo.npus), pipelined=pipelined)
            t0 = time.perf_counter()
            alg = core.SynthesisEngine(topo).collective(req)
            synth_s = time.perf_counter() - t0
            try:
                alg.validate()
            except AssertionError as e:
                fail(f"switch buffers, {case}: the copy's plan fails validate(): {e}")
            peaks = switch_peaks(alg)
            if not peaks or any(p > limit for p in peaks.values()):
                fail(f"switch buffers, {case}: peak occupancy {peaks} over the limit {limit}")
            prog = primitives.lower_algorithm(alg, key=f"switch buffers {case}")
            rng = np.random.default_rng(7)
            shape = {"all_gather": (n, EXEC_PAYLOAD),
                     "all_reduce": (n, n * EXEC_PAYLOAD)}.get(kind, (n, n, EXEC_PAYLOAD))
            x = rng.standard_normal(shape).astype(np.float32)
            fn = getattr(primitives, f"pccl_{kind}")
            xd = torch.from_numpy(x).to(dev)
            got = fn(xd, None, req, program=prog).cpu().numpy()
            interp = primitives.interpret_collective(kind, x, None, req, program=prog)
            if not np.array_equal(got.view(np.uint32), interp.view(np.uint32)):
                fail(f"switch buffers, {case}: the card's result differs from the numpy "
                     f"interpreter")
            want = exec_reference(kind, range(n), x)
            err = float(np.abs(got - want).max())
            exact = kind in ("all_gather", "all_to_all")
            if not (np.array_equal(got, want) if exact else
                    bool((np.abs(got - want) <= EXEC_TOL + EXEC_TOL * np.abs(want)).all())):
                fail(f"switch buffers, {case}: the result misses the plain collective "
                     f"(max abs err {err:.3g})")
            ms = statistics.median(time_ms(torch, lambda: fn(xd, None, req, program=prog), 20)
                                   for _ in range(3))
            occ = ", ".join(f"switch {sw} {p}/{limit}" for sw, p in peaks.items())
            print(f"  {case}: makespan {alg.makespan:g}, {len(alg.transfers)} transfers, "
                  f"{prog[0].num_rounds} rounds, {prog[0].num_sends} sends; peak occupancy "
                  f"{occ}; synthesis {synth_s * 1e3:.1f} ms on the host; max abs err "
                  f"{err:.3g} ({'exact' if exact else f'tol {EXEC_TOL}'}); {ms:.4f} ms a call")
            rows.append((case, alg.makespan, prog[0].num_rounds, ms))
            del xd
            if (label, kind, pipelined) == ("star8_b1", "all_gather", False):
                planted = switch_fault(alg)
                try:
                    planted.validate()
                    fail("switch buffers: validate() accepted an arrival shifted into a "
                         "full buffer")
                except AssertionError as e:
                    if "buffer exceeded" not in str(e):
                        fail(f"switch buffers: the planted fault failed otherwise: {e}")
                    print(f"  planted fault (one arrival of {case} shifted into a full "
                          f"buffer): validate() rejects it: {e}")

    # four threads on one shared topology: every plan the single-thread plan
    limit = 2
    shared = topology.star_switch(n, buffer_limit=limit)
    reqs = [core.CollectiveRequest(kind, group=tuple(range(n)), pipelined=pipelined)
            for kind, pipelined in SWITCH_KINDS]
    want = [core.SynthesisEngine(topology.star_switch(n, buffer_limit=limit)).collective(r)
            for r in reqs]
    got, errors = [], []

    def work():
        try:
            for r in reqs:
                got.append((r, core.SynthesisEngine(shared).collective(r)))
        except Exception as e:  # noqa: BLE001 - reported below, and the phase fails
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=work, daemon=True) for _ in range(SWITCH_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=SWITCH_JOIN_S)
    if any(th.is_alive() for th in threads):
        fail(f"switch buffers: threads still synthesizing after {SWITCH_JOIN_S:g} s")
    if errors or len(got) != SWITCH_THREADS * len(reqs):
        fail(f"switch buffers: the threads raised {errors}")
    for r, alg in got:
        ref = want[reqs.index(r)]
        if not all(np.array_equal(getattr(alg.columns, col), getattr(ref.columns, col))
                   for col in ("chunk", "link", "src", "dst", "start", "end", "reduce")):
            fail(f"switch buffers: a thread's {r.kind} plan differs from the single-thread plan")
    print(f"  {SWITCH_THREADS} threads x {len(reqs)} collectives on one shared "
          f"star_switch({n}, buffer_limit={limit}): every plan the single-thread plan "
          f"({time.perf_counter() - t0:.2f} s)")
    executor.clear_plan_cache()
    print(f"switch_buffers: {len(rows)} cases; makespan/rounds/ms "
          + "; ".join(f"{c} {m:g}/{r}/{ms:.4f}" for c, m, r, ms in rows)
          + f"; on {smi_line}; {time.perf_counter() - t_phase:.1f} s")


def flash_counters(fa) -> tuple:
    """Every flash kernel's launch counter: the routed forward's total, each
    forward route's, the routed backward's total and each backward route's."""
    return (fa.flash_attention, fa.flash_attention_wgmma, fa.flash_attention_mma,
            fa.flash_attention_wide, fa.flash_attention_bwd, fa.flash_attention_bwd_wgmma,
            fa.flash_attention_bwd_mma)


def bwd_want(fa, n: int, hd: int, dtype: str = "bfloat16") -> dict:
    """The launches ``n`` backward calls at (dtype, head_dim) count on each
    backward counter, by name: the total, and all of them on the route that
    ``BWD_ROUTES`` names (bf16 at hd 64 and 128: wgmma; else mma)."""
    import torch

    route = fa.bwd_route(getattr(torch, dtype), hd)
    return {"flash_attention_bwd": n, "flash_attention_bwd_wgmma": n * (route == "wgmma"),
            "flash_attention_bwd_mma": n * (route == "mma")}


def bwd_counters(fa, n: int, hd: int, dtype: str = "bfloat16") -> dict:
    """``bwd_want`` keyed by the counters themselves."""
    return {getattr(fa, name): k for name, k in bwd_want(fa, n, hd, dtype).items()}


def backward_phase(torch, dev, gen, fa, ops, flash_attention_ref,
                   flash_attention_bwd_ref) -> dict:
    """The backward's two routes against their plain version at
    ``BWD_CASES``: every case through the router (``BWD_ROUTES``: bf16 at hd
    64 and 128 on the wgmma route), each launch counted on its route, and
    the bf16 hd 64 / 128 cases through the mma route too; a planted fault
    that the check must catch; two calls bit-equal; then both routes timed
    at the training shape beside the plain version, the bound and SDPA's
    backward, with the device time of each pass. Returns the kernels-line
    numbers of both routes."""
    from repro_torch.launch import trace

    phase("flash backward kernel checks")
    counters = (fa.flash_attention_bwd, fa.flash_attention_bwd_wgmma,
                fa.flash_attention_bwd_mma)
    err = {"wgmma": None, "mma": None}
    for B, S, T, H, KV, hd, dt, kw in BWD_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(dtype)
        do = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
        o = flash_attention_ref(q, k, v, **kw)
        route = fa.bwd_route(dtype, hd)
        before = [c.launches for c in counters]
        got = ops.flash_attention_bwd(q, k, v, o, do, **kw)
        torch.cuda.synchronize()
        if [c.launches - n for c, n in zip(counters, before)] != [
                1, route == "wgmma", route == "mma"]:
            fail(f"the backward did not count one launch on its {route} route")
        want = flash_attention_bwd_ref(q, k, v, o, do, **kw)
        tol = F32_TOL if dt == "float32" else BF16_TOL
        runs = {route: got}
        if route == "wgmma":  # the mma route at the same case
            runs["mma"] = fa.flash_attention_bwd_mma(q, k, v, o, do, **kw)
            torch.cuda.synchronize()
        line = []
        for name, grads in runs.items():
            checked = [compare(g, w, tol) for g, w in zip(grads, want)]
            ok = all(c[1] for c in checked) and all(bool(torch.isfinite(g).all()) for g in grads)
            line.append(f"{name} max_abs_err dq/dk/dv "
                        f"{' / '.join(f'{c[0]:.3g}' for c in checked)} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the backward's {name} route disagrees with its plain version at "
                     f"{(B, S, T, H, KV, hd, dt, kw)}")
            if (B, S, H, KV, hd) == TRAIN_SHAPE and dt == "bfloat16":
                err[name] = max(c[0] for c in checked)
        if len(runs) == 2:
            line.append("|wgmma - mma| " + " / ".join(
                f"{float((a.float() - b.float()).abs().max()):.3g}"
                for a, b in zip(runs["wgmma"], runs["mma"])))
        print(f"  B={B} S={S} T={T} H={H} KV={KV} hd={hd} {dt} {kw} (tol {tol}): "
              + "; ".join(line))

    # planted fault: dk and dv summed over the first query head of each
    # group only (the wgmma kernel run on those heads alone); the check
    # must fail it
    B, S, H, KV, hd = 2, 192, 4, 2, 64
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd)))
    o = flash_attention_ref(q, k, v, causal=True)
    group = H // KV
    faulty = fa.flash_attention_bwd_wgmma(q[:, :, ::group], k, v, o[:, :, ::group],
                                          do[:, :, ::group], causal=True)
    want = flash_attention_bwd_ref(q, k, v, o, do, causal=True)
    caught = [compare(g, w, BF16_TOL) for g, w in zip(faulty[1:], want[1:])]
    print(f"  planted fault (dk, dv over the first head of each group of {group} only) at "
          f"{(B, S, H, KV, hd)} bfloat16 causal: max_abs_err dk/dv "
          f"{' / '.join(f'{c[0]:.3g}' for c in caught)} "
          f"{'PASSED: FAIL' if all(c[1] for c in caught) else 'fails, as it must'}")
    if all(c[1] for c in caught):
        fail("the backward check passed dk and dv summed over one head of each group")
    del q, k, v, o, do, faulty, want

    (q, k, v), (qt, kt, vt) = attention_inputs(torch, gen, dev, TRAIN_SHAPE, "bfloat16")
    o = ops.flash_attention(q, k, v, causal=True)
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    qt, kt, vt = (x.requires_grad_(True) for x in (qt, kt, vt))
    ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    first = ops.flash_attention_bwd(q, k, v, o, do, causal=True)
    for g, w in zip(first, torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)):
        torch.testing.assert_close(g.float(), w.transpose(1, 2).float(),
                                   rtol=BF16_TOL, atol=BF16_TOL)
    # no atomics, every sum in a fixed order: a second call gives the same bits
    if not all(torch.equal(a, b) for a, b in
               zip(first, ops.flash_attention_bwd(q, k, v, o, do, causal=True))):
        fail("two backward calls at the training shape gave different dq, dk or dv")
    print(f"  training shape {TRAIN_SHAPE} bfloat16 causal "
          f"({fa.bwd_route(q.dtype, q.shape[-1])} route): two calls bit-equal (dq, dk, dv)")
    del first
    fns = {"wgmma": (lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=True), 20),
           "mma": (lambda: fa.flash_attention_bwd_mma(q, k, v, o, do, causal=True), 20),
           "plain": (lambda: flash_attention_bwd_ref(q, k, v, o, do, causal=True), 3),
           "sdpa_bwd": (lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                    retain_graph=True), 20)}
    times = time_turns(torch, fns)
    bound = attention_bwd_bound(q, k, True, 0)
    print(f"  training shape {TRAIN_SHAPE} bfloat16 causal: wgmma route {times['wgmma']:.4f} "
          f"ms, mma route {times['mma']:.4f} ms ({times['mma'] / times['wgmma']:.2f}x the "
          f"wgmma route's), plain {times['plain']:.4f} ms, sdpa backward "
          f"{times['sdpa_bwd']:.4f} ms (wgmma {times['wgmma'] / times['sdpa_bwd']:.2f}x); bound "
          f"{bound[0] * 1e3:.2f} us by {bound[1]} ({bound[2] / 1e9:.2f} GFLOP, "
          f"{bound[3] / 1e6:.1f} MB: {bound_terms(bound[4])}); wgmma at "
          f"{bound[2] / times['wgmma'] / 1e9:.2f} TFLOP/s of the backward's products, "
          f"{times['wgmma'] / bound[0]:.2f}x its bound; mma {times['mma'] / bound[0]:.2f}x")
    # device time of each pass, from the profiler's kernel records; host cost of a call
    calls, passes, host = 5, {}, {}
    for route in ("wgmma", "mma"):
        run = fns[route][0]
        by_name = trace.traced(lambda: [run() for _ in range(calls)], dev)["by_name"]
        passes[route] = {m[1]: us / calls / 1e3 for name, us in by_name.items()
                         if (m := re.search(r"flash_bwd_(?:wgmma_)?(lse|dkdv|dq)_kernel", name))}
        host[route] = host_us(torch, run)
        print(f"  training shape bfloat16, {route} route: device time by pass (profiler, "
              f"{calls} calls) " + ", ".join(f"{n} {ms:.4f} ms" for n, ms in passes[route].items())
              + f" ({sum(passes[route].values()):.4f} ms in all); host {host[route]:.1f} us a call")
    # SDPA's backward through autograd: its kernels' device time, beside the
    # CUDA events' time, which its host cost can set
    run = fns["sdpa_bwd"][0]
    sdpa_device = sum(trace.traced(lambda: [run() for _ in range(calls)],
                                   dev)["by_name"].values()) / calls / 1e3
    print(f"  training shape bfloat16, sdpa backward: device time (profiler, {calls} calls) "
          f"{sdpa_device:.4f} ms, CUDA events {times['sdpa_bwd']:.4f} ms")
    del q, k, v, o, do, qt, kt, vt, ot, dot, fns, run

    # the same in f32 (the mma forward, the mma backward in 3xTF32): printed,
    # not in the kernels line (the training path runs bf16)
    (q, k, v), (qt, kt, vt) = attention_inputs(torch, gen, dev, TRAIN_SHAPE, "float32")
    o = ops.flash_attention(q, k, v, causal=True)
    do = torch.randn(q.shape, generator=gen, device=dev)
    qt, kt, vt = (x.requires_grad_(True) for x in (qt, kt, vt))
    ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    diff = max(float((g - w.transpose(1, 2)).abs().max()) for g, w in zip(
        ops.flash_attention_bwd(q, k, v, o, do, causal=True),
        torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)))
    f32 = time_pair(torch, {
        "kernel": lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=True),
        "sdpa_bwd": lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)},
        10)
    bound32 = attention_bwd_bound(q, k, True, 0)
    print(f"  training shape {TRAIN_SHAPE} float32 causal (mma route): kernel "
          f"{f32['kernel']:.4f} ms, sdpa backward {f32['sdpa_bwd']:.4f} ms "
          f"({f32['kernel'] / f32['sdpa_bwd']:.2f}x; max abs diff {diff:.3g}); bound "
          f"{bound32[0] * 1e3:.2f} us by {bound32[1]} ({bound_terms(bound32[4])}); kernel "
          f"{f32['kernel'] / bound32[0]:.2f}x its bound")
    return {route: dict(err=err[route], ms=times[route], plain_ms=times["plain"],
                        library_ms=times["sdpa_bwd"], library_device_ms=sdpa_device,
                        bound=bound, passes=passes[route], host_us=host[route])
            for route in ("wgmma", "mma")}


def start_wgmma_fault_build(build):
    """Start nvcc on a copy of ``csrc/flash_attention_wgmma.cu`` whose three
    tensor maps span the instance's width (``HD``, 128) instead of the
    call's head_dim: the planted fault of ``wgmma_fault_checks``. Returns
    (library path, nvcc process)."""
    src = (build.CSRC / "flash_attention_wgmma.cu").read_text()
    faulty, n = re.subn(r"(make_map\(encode, &tm_[qkv], [qkv], B, \w+, \w+, )hd,", r"\1HD,",
                        src)
    if n != 3:
        fail("the wgmma source no longer passes hd to its three tensor maps as "
             "'make_map(encode, &tm_x, x, B, L, N, hd, ...'; the planted fault cannot be "
             "made")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "flash_attention_wgmma_fault128.cu"
    path.write_text(faulty)
    lib = path.with_suffix(".so")
    proc = subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc


def wgmma_fault_checks(torch, gen, dev, fa, ops, fault_build, flash_attention_ref) -> None:
    """q/k/v as views of one projection whose rows hold, just past each
    head's hd columns, 8 columns of large values (``WGMMA_FAULT_CASE`` at
    ``WGMMA_FAULT_HEAD_DIMS``): the wgmma route (one launch) within
    ``BF16_TOL`` of the plain version, and the copy built with 128-column
    tensor maps (``start_wgmma_fault_build``), which reads those columns and
    the next head's, outside it."""
    import ctypes

    lib, proc = fault_build
    out, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc failed on the planted-fault copy of the wgmma kernel:\n{out}")
    dll = ctypes.CDLL(str(lib))
    fn, err_str = dll.repro_flash_attention_wgmma_fwd, dll.repro_wgmma_cuda_error_string
    fn.argtypes, fn.restype = fa._FWD_ARGS, ctypes.c_int
    err_str.argtypes, err_str.restype = [ctypes.c_int], ctypes.c_char_p
    fa._fns["flash_attention_wgmma_fault128"] = (fn, err_str)
    B, S, H, KV = WGMMA_FAULT_CASE
    for hd in WGMMA_FAULT_HEAD_DIMS:
        # one row past S keeps the faulty maps' reads of the last head inside
        # the allocation
        rows = torch.randn((B, S + 1, H + 2 * KV, hd + 8), generator=gen, device=dev)
        rows[..., hd:] *= 100.0
        rows = rows.to(torch.bfloat16)[:, :S]
        q, k, v = rows[:, :, :H, :hd], rows[:, :, H:H + KV, :hd], rows[:, :, H + KV:, :hd]
        want = flash_attention_ref(q, k, v, causal=True)
        before = fa.flash_attention_wgmma.launches
        got = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        if fa.flash_attention_wgmma.launches != before + 1:
            fail(f"the fault case at hd {hd} did not go to the wgmma route")
        err, ok = compare(got, want, BF16_TOL)
        strides = (*fa.tma_strides(q), *fa.tma_strides(k), *fa.tma_strides(v))
        faulty, _ = fa._launch("flash_attention_wgmma_fault128",
                               "repro_flash_attention_wgmma_fwd",
                               "repro_wgmma_cuda_error_string", q, k, v, strides, True, 0, 0.0)
        torch.cuda.synchronize()
        fault_err, fault_ok = compare(faulty, want, BF16_TOL)
        print(f"  wgmma: B={B} S={S} H={H} KV={KV} hd={hd} bfloat16 causal, q/k/v views of "
              f"one projection with 8 columns of large values past each head: "
              f"max_abs_err={err:.3g} (tol {BF16_TOL}) {'ok' if ok else 'FAIL'}; planted "
              f"fault (tensor maps of 128 columns): max_abs_err={fault_err:.3g} "
              f"{'PASSED: FAIL' if fault_ok else 'fails, as it must'}")
        if not (ok and torch.isfinite(got).all()):
            fail(f"the wgmma route disagrees with its plain version at hd {hd} with large "
                 f"values past each head's columns")
        if fault_ok:
            fail(f"the check passed the wgmma kernel with 128-column tensor maps at hd {hd}")
        del rows, q, k, v, want, got, faulty
    del fa._fns["flash_attention_wgmma_fault128"]


def padded_head_dim_times(torch, gen, dev, fa, ops, smi_line: str) -> list:
    """The wgmma route at ``PADDED_HEAD_DIM_SHAPES`` (bf16, causal; the
    hd-128 instance with zero-filled columns), the mma route on the same
    inputs, SDPA and the bound, three rounds in turns. Returns the kernels
    line's ``head_dims`` rows."""
    rows = []
    for arch, shape in PADDED_HEAD_DIM_SHAPES.items():
        (q, k, v), (qt, kt, vt) = attention_inputs(torch, gen, dev, shape, "bfloat16")
        if fa.route(q.dtype, q.shape[-1]) != "wgmma":
            fail(f"{arch}'s head_dim {q.shape[-1]} does not route to the wgmma kernel")
        fns = {"wgmma": lambda: ops.flash_attention(q, k, v, causal=True),
               "mma": lambda: fa.flash_attention_mma(q, k, v, causal=True),
               "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True)}
        wgmma, mma = fns["wgmma"](), fns["mma"]()
        torch.testing.assert_close(wgmma.float(), fns["sdpa"]().transpose(1, 2).float(),
                                   rtol=BF16_TOL, atol=BF16_TOL)
        torch.testing.assert_close(wgmma.float(), mma.float(), rtol=BF16_TOL, atol=BF16_TOL)
        got = time_pair(torch, fns, 100)
        bound_ms, bound_by, flops, nbytes, terms = attention_bound(q, k, v, True, 0)
        print(f"  {arch}'s head_dim {shape[-1]}: {shape} bfloat16 causal ({smi_line}): wgmma "
              f"{got['wgmma']:.4f} ms, mma {got['mma']:.4f} ms (wgmma "
              f"{got['mma'] / got['wgmma']:.2f}x faster), sdpa {got['sdpa']:.4f} ms (wgmma "
              f"{got['wgmma'] / got['sdpa']:.2f}x); bound {bound_ms * 1e3:.2f} us by {bound_by} "
              f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB: {bound_terms(terms)}); wgmma "
              f"at {flops / got['wgmma'] / 1e9:.2f} TFLOP/s, {got['wgmma'] / bound_ms:.2f}x "
              f"its bound")
        if got["wgmma"] >= got["mma"]:
            fail(f"the wgmma route at {arch}'s {shape} is not faster than the mma route")
        rows.append({"arch": arch, "shape": list(shape), "ms": got["wgmma"],
                     "mma_ms": got["mma"], "library_ms": got["sdpa"], "bound_ms": bound_ms,
                     "bound_by": bound_by})
        del q, k, v, qt, kt, vt, fns, wgmma, mma
    return rows


def encdec_vlm_kernel_phase(torch, dev, gen, fa, ops, flash_attention_ref,
                            flash_attention_bwd_ref) -> None:
    """The flash forward and backward at ``ENCDEC_VLM_SHAPES`` (checked
    against their plain versions in the kernel phases above), timed beside
    their plain versions, their bounds and SDPA's forward and backward
    (``enable_gqa``, a yardstick the port never calls): bf16 at every shape
    (the backward on the wgmma route, and on the mma route beside it), f32
    (the mma routes, the backward in 3xTF32) at whisper's. Printed, not in
    the kernels line."""
    phase("flash kernels at the encdec and vlm shapes")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, (B, S, T, H, KV, hd, causal) in ENCDEC_VLM_SHAPES.items():
        for dt in ("bfloat16", "float32") if H == 16 else ("bfloat16",):
            (q, k, v), (qt, kt, vt) = attention_inputs(torch, gen, dev, (B, S, H, KV, hd),
                                                       dt, T)
            o = ops.flash_attention(q, k, v, causal=causal)
            do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
            qt, kt, vt = (x.requires_grad_(True) for x in (qt, kt, vt))
            ot = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
            dot = do.transpose(1, 2).contiguous()
            tol = F32_TOL if dt == "float32" else BF16_TOL
            torch.testing.assert_close(ot.detach().transpose(1, 2).float(), o.float(),
                                       rtol=tol, atol=tol)
            big = B * H * S * T > 5e8  # the plain versions' f32 scores take GBs
            bwd_route = fa.bwd_route(q.dtype, hd)
            fns = {
                "kernel": (lambda: ops.flash_attention(q, k, v, causal=causal), 20),
                "plain": (lambda: flash_attention_ref(q, k, v, causal=causal), 1 if big else 3),
                "sdpa": (lambda: sdpa(qt.detach(), kt.detach(), vt.detach(), is_causal=causal,
                                      enable_gqa=True), 20),
                "bwd": (lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=causal), 10),
                "plain_bwd": (lambda: flash_attention_bwd_ref(q, k, v, o, do, causal=causal), 1),
                "sdpa_bwd": (lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                         retain_graph=True), 10)}
            runs = [("forward", fa.route(q.dtype, hd), attention_bound(q, k, v, causal, 0),
                     "kernel", "plain", "sdpa"),
                    ("backward", bwd_route, attention_bwd_bound(q, k, causal, 0), "bwd",
                     "plain_bwd", "sdpa_bwd")]
            if bwd_route == "wgmma":  # the mma route beside it
                fns["bwd_mma"] = (lambda: fa.flash_attention_bwd_mma(q, k, v, o, do,
                                                                     causal=causal), 10)
                runs.append(("backward", "mma", runs[1][2], "bwd_mma", "plain_bwd", "sdpa_bwd"))
            got = time_turns(torch, fns)
            for what, route, bound, kernel, plain, lib in runs:
                print(f"  {name} {(B, S, T, H, KV, hd)} {dt} {'causal' if causal else 'non-causal'}"
                      f", {what} ({route}): kernel {got[kernel]:.4f} ms, plain {got[plain]:.4f} "
                      f"ms, sdpa {got[lib]:.4f} ms ({got[kernel] / got[lib]:.2f}x SDPA); bound "
                      f"{bound[0] * 1e3:.2f} us by {bound[1]} ({bound[2] / 1e9:.2f} GFLOP, "
                      f"{bound_terms(bound[4])}); kernel at {bound[2] / got[kernel] / 1e9:.2f} "
                      f"TFLOP/s, {got[kernel] / bound[0]:.2f}x its bound")
            del q, k, v, o, do, qt, kt, vt, ot, dot
            torch.cuda.empty_cache()


def training_phase(torch, dev, get_config, LM, fa, flash_attention_ref,
                   flash_attention_bwd_ref) -> dict:
    """Full-width llama3.2-1b training steps on the card: bf16 compute, f32
    master params and AdamW state, remat per block. The first step (the
    warm-up) beside the same step through the plain attention; then
    ``TRAIN_STEPS`` timed steps with the flash launches counted over them.
    Returns the counts."""
    from repro_torch.bridge import named_leaves
    from repro_torch.data.pipeline import _batch_for_step
    from repro_torch.launch import trace
    from repro_torch.launch.train_lm import DATA_SEED, loss_and_grads
    from repro_torch.optim import adamw_init, adamw_update, cosine_schedule, global_norm

    phase("train llama3.2-1b")
    torch.cuda.empty_cache()
    cfg = get_config("llama3.2-1b")
    B, S = TRAIN_SHAPE[:2]
    lm = LM(cfg, device=dev, remat=True)
    params = lm.init(0, param_dtype=torch.float32)
    for _, t in named_leaves(params):
        t.requires_grad_(True)
    print(f"{cfg.name}: {count_params(params)} params (f32 master weights), compute "
          f"{cfg.dtype}, {cfg.num_layers} layers, batch {B} x {S} tokens, remat per block")
    batches = [{key: torch.from_numpy(val).to(dev, torch.int64) for key, val in
                _batch_for_step(DATA_SEED, step, B, S, cfg.vocab_size).items()}
               for step in range(1 + TRAIN_STEPS)]

    plain = LM(cfg, device=dev, remat=True, attention=flash_attention_ref,
               attention_bwd=flash_attention_bwd_ref)
    plain_loss, grads = loss_and_grads(plain, params, batches[0])
    plain_loss, plain_gnorm = float(plain_loss), float(global_norm(grads))
    del grads
    opt = adamw_init(params)
    lr = cosine_schedule(3e-4, warmup=20, total=100)
    loss, grads = loss_and_grads(lm, params, batches[0])
    loss, gnorm = float(loss), float(global_norm(grads))
    adamw_update(params, grads, opt, lr=lr)
    del grads
    rel_loss = abs(loss - plain_loss) / abs(plain_loss)
    rel_gnorm = abs(gnorm - plain_gnorm) / plain_gnorm
    print(f"  first step, kernels vs plain attention: loss {loss:.6f} vs {plain_loss:.6f} "
          f"(rel {rel_loss:.3g}, tol {TRAIN_LOSS_REL_TOL}); grad norm {gnorm:.6f} vs "
          f"{plain_gnorm:.6f} (rel {rel_gnorm:.3g})")
    if not (rel_loss <= TRAIN_LOSS_REL_TOL and finite(loss, gnorm)):
        fail("the first training step's loss disagrees with the plain attention's")

    counters = flash_counters(fa)
    for counter in counters:
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, losses, gnorms = [], [], []
    for step in range(1, 1 + TRAIN_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(lm, params, batches[step])
        _, _, metrics = adamw_update(params, grads, opt, lr=lr)
        del grads
        torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        gnorms.append(float(metrics["grad_norm"]))
    launches = {counter.__name__: counter.launches for counter in counters}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  steps {list(range(1, 1 + TRAIN_STEPS))}: loss "
          f"{', '.join(f'{x:.6f}' for x in losses)}; grad norm "
          f"{', '.join(f'{x:.6f}' for x in gnorms)}; ms {', '.join(f'{x:.3f}' for x in step_ms)}")
    ms = statistics.median(step_ms)
    print(f"train llama3.2-1b: step_ms={ms:.3f} tok_per_s={B * S / ms * 1e3:.1f} "
          f"max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB) " +
          " ".join(f"{name}_launches_per_step={n / TRAIN_STEPS:g}"
                   for name, n in launches.items()))
    L = cfg.num_layers
    want = {"flash_attention": 2 * L * TRAIN_STEPS, "flash_attention_wgmma": 2 * L * TRAIN_STEPS,
            "flash_attention_mma": 0, "flash_attention_wide": 0,
            **bwd_want(fa, L * TRAIN_STEPS, cfg.head_dim, cfg.dtype)}
    if launches != want:
        fail(f"flash launches over {TRAIN_STEPS} training steps {launches}, want {want} (the "
             f"forward once a layer and again in remat's recompute, the backward once)")
    if not finite(*losses, *gnorms):
        fail("a training step's loss or gradient norm is not finite")

    def one_step():
        _, grads = loss_and_grads(lm, params, batches[-1])
        adamw_update(params, grads, opt, lr=lr)

    # one more step under the profiler: where a step's time goes
    trace.print_phase("train llama3.2-1b, one step traced", trace.traced(one_step, dev), 1, 8)
    del lm, plain, params, opt, batches
    torch.cuda.empty_cache()
    return launches


def carry_dropped(bwd):
    """``bwd`` with a planted fault: the adjoint carried into a chunk from
    the later chunks dropped, so that a chunk's gradients of x, dt, B and C
    see only its own positions' dy (dA left as ``bwd`` gives it). Each
    chunk's rows come from ``bwd`` over the positions up to its end with dy
    zero outside it."""
    import torch

    def faulty(xh, dt, A, Bm, Cm, dy, *, chunk):
        out = [torch.zeros_like(t) for t in (xh, dt, A, Bm, Cm)]
        out[2] = bwd(xh, dt, A, Bm, Cm, dy, chunk=chunk)[2]
        S = xh.shape[1]
        for t0 in range(0, S, chunk):
            t1 = min(S, t0 + chunk)
            own = dy[:, :t1].clone()
            own[:, :t0] = 0
            got = bwd(xh[:, :t1], dt[:, :t1], A, Bm[:, :t1], Cm[:, :t1], own, chunk=chunk)
            for i in (0, 1, 3, 4):
                out[i][:, t0:t1] = got[i][:, t0:t1]
        return tuple(out)
    return faulty


def ssd_bwd_phase(torch, dev, gen, ops, ssd, ssd_scan_bwd_ref) -> dict:
    """The SSD backward kernel against its plain version at
    ``SSD_BWD_CASES``, a planted fault that the check must fail, two calls
    bit-equal, and its time at the training shapes beside the plain version
    and its bound. Returns the kernels-line numbers (mamba2-370m's shape)."""
    from repro_torch.launch import trace

    phase("SSD backward kernel checks")
    names = ("dxh", "ddt", "dA", "dBm", "dCm")
    err = 0.0

    def inputs(B, S, H, P, N, slow):
        ins = ssd_inputs(torch, gen, dev, B, S, H, P, N, slow)
        return (*ins, torch.randn((B, S, H, P), generator=gen, device=dev))

    for B, S, H, P, N, chunk, slow in SSD_BWD_CASES:
        ins = inputs(B, S, H, P, N, slow)
        before = ssd.ssd_scan_bwd.launches
        got = ops.ssd_scan_bwd(*ins, chunk=chunk)
        torch.cuda.synchronize()
        p_cuts, n_cuts, run_chunk = ssd.slice_plan(P, N, chunk)
        if ssd.ssd_scan_bwd.launches != before + len(p_cuts) * len(n_cuts):
            fail("the SSD backward wrapper did not count its launches")
        groups = ssd.bwd_groups(dev, B, S, H, p_cuts[0][2], n_cuts[0][2], run_chunk)
        if (B, S, H, P, N, chunk, slow) in SSD_BWD_GROUP_CASES and groups[:2] == (1, 1):
            fail(f"the SSD backward grouped no heads at {(B, S, H, P, N, chunk)}")
        want = ssd_scan_bwd_ref(*ins, chunk=chunk)
        checked = [compare_scaled(g, w, SSD_BWD_TOL) for g, w in zip(got, want)]
        ok = all(c[1] for c in checked)
        print(f"  B={B} S={S} H={H} P={P} N={N} chunk={chunk}{' slow decay' if slow else ''} "
              f"G={groups[0]},{groups[1]}: "
              f"max_abs_err {' / '.join(f'{n} {c[0]:.3g}' for n, c in zip(names, checked))} "
              f"(tol {SSD_BWD_TOL} x max |plain|) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the SSD backward kernel disagrees with its plain version at "
                 f"{(B, S, H, P, N, chunk, slow)}")
        if (B, S, H, P, N, chunk) == SSD_BWD_SHAPES["mamba2-370m"]:
            err = max(err, *(c[0] for c in checked))
        del ins, got, want

    # the planted fault, on slow-decay inputs at mamba2-370m's shape
    B, S, H, P, N, chunk = SSD_BWD_SHAPES["mamba2-370m"]
    ins = inputs(B, S, H, P, N, True)
    want = ssd_scan_bwd_ref(*ins, chunk=chunk)
    got = carry_dropped(ops.ssd_scan_bwd)(*ins, chunk=chunk)
    checked = [compare_scaled(g, w, SSD_BWD_TOL) for g, w in zip(got, want)]
    print(f"  planted fault (the adjoint's inter-chunk carry dropped), slow decay: max_abs_err "
          f"{' / '.join(f'{n} {c[0]:.3g}' for n, c in zip(names, checked))} (must fail "
          f"tol {SSD_BWD_TOL} x max |plain|)")
    if all(c[1] for c in checked):
        fail("the SSD backward check passes a planted fault (the carry dropped)")
    del ins, got, want

    out = {}
    for arch, (B, S, H, P, N, chunk) in SSD_BWD_SHAPES.items():
        ins = inputs(B, S, H, P, N, False)
        first = ops.ssd_scan_bwd(*ins, chunk=chunk)
        if not all(torch.equal(a, b) for a, b in zip(first, ops.ssd_scan_bwd(*ins, chunk=chunk))):
            fail(f"two SSD backward calls at {arch}'s shape gave different gradients")
        del first
        fns = {"ms": (lambda: ops.ssd_scan_bwd(*ins, chunk=chunk), 10),
               "plain_ms": (lambda: ssd_scan_bwd_ref(*ins, chunk=chunk), 2)}
        times = time_turns(torch, fns)
        bound = ssd_bwd_bound(ins[0], ins[3], chunk)
        calls = 3
        by_name = trace.traced(lambda: [fns["ms"][0]() for _ in range(calls)], dev)["by_name"]
        passes = {}
        for name, us in by_name.items():
            if m := re.search(r"ssd_(bwd_\w+?|chunk_state|state_pass)_kernel", name):
                passes[m[1]] = passes.get(m[1], 0.0) + us / calls / 1e3
        print(f"  {arch}'s shape {(B, S, H, P, N, chunk)} f32: two calls bit-equal; kernel "
              f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms; bound "
              f"{bound[0] * 1e3:.2f} us by {bound[1]} ({bound[2] / 1e9:.2f} GFLOP, "
              f"{bound[3] / 1e6:.1f} MB: {bound_terms(bound[4])}); kernel at "
              f"{bound[2] / times['ms'] / 1e9:.2f} TFLOP/s of counted operations, "
              f"{times['ms'] / bound[0]:.2f}x its bound")
        print(f"  {arch}'s shape, device time by pass (profiler, {calls} calls): " +
              ", ".join(f"{name} {ms:.4f} ms" for name, ms in passes.items()))
        if times["ms"] < bound[0]:
            fail(f"the SSD backward reads {times['ms']:.4f} ms, below its {bound[0]:.4f} ms "
                 f"bound: the timing or the bound is wrong")
        out[arch] = dict(times, bound=bound)
        del ins, fns
    return dict(out["mamba2-370m"], err=err)


def zamba2_bwd_times(torch, dev, fa, ops, trace, q, k, v, o, do) -> dict:
    """The flash backward at ``ZAMBA2_ATTN`` (the route ``BWD_ROUTES``
    names, the mma route at hd 112) beside SDPA's backward through
    autograd, three rounds in turns by CUDA events, and the device time of
    each from the profiler's kernel records; the bound
    (``attention_bwd_bound``). Returns the kernels line's numbers."""
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    route = fa.bwd_route(q.dtype, q.shape[-1])
    fns = {"kernel": lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=True),
           "sdpa_bwd": lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)}
    for g, w in zip(fns["kernel"](), fns["sdpa_bwd"]()):
        torch.testing.assert_close(g.float(), w.transpose(1, 2).float(),
                                   rtol=BF16_TOL, atol=BF16_TOL)
    got = time_pair(torch, fns, 20)
    calls = 5
    device = {name: sum(trace.traced(lambda: [fn() for _ in range(calls)],
                                     dev)["by_name"].values()) / calls / 1e3
              for name, fn in fns.items()}
    bound = attention_bwd_bound(q, k, True, 0)
    print(f"  flash backward at {ZAMBA2_ATTN} bfloat16 causal, {route} route: kernel "
          f"{got['kernel']:.4f} ms (device {device['kernel']:.4f}), sdpa backward "
          f"{got['sdpa_bwd']:.4f} ms (device {device['sdpa_bwd']:.4f}; kernel "
          f"{got['kernel'] / got['sdpa_bwd']:.2f}x by CUDA events, "
          f"{device['kernel'] / device['sdpa_bwd']:.2f}x by device time); bound "
          f"{bound[0] * 1e3:.2f} us by {bound[1]} ({bound[2] / 1e9:.2f} GFLOP, "
          f"{bound[3] / 1e6:.1f} MB: {bound_terms(bound[4])}); kernel "
          f"{got['kernel'] / bound[0]:.2f}x its bound")
    return {"shape": list(ZAMBA2_ATTN), "route": route, "ms": got["kernel"],
            "device_ms": device["kernel"], "library_ms": got["sdpa_bwd"],
            "library_device_ms": device["sdpa_bwd"], "bound_ms": bound[0],
            "bound_by": bound[1]}


def family_training_phase(torch, dev, fa, ssd, arch: str, *, layers: int | None = None,
                          f32_layers: int | None = None, seq: int = TRAIN_SHAPE[1],
                          plain_rows: int | None = None, no_f32: str = "",
                          why: str = "") -> dict:
    """Training steps of ``arch`` (the ssm, hybrid, moe, encdec or vlm
    family) on the card at full width, ``layers`` of its layers if given
    (``why`` says why): bf16 compute, f32 master params and AdamW state,
    remat per block, 4 x ``seq`` tokens a step (behind 4 x 2880 stub
    patches in the vlm, over 4 x 1500 stub frames in the encdec family).
    The first step's loss beside the same step through the chunked plain
    scan, its autograd backward and the plain attention (on the first
    ``plain_rows`` rows if given: the plain attention's dense f32 scores of
    every row do not fit beside the model); unless ``no_f32`` says why not,
    the same first step in f32 (at ``f32_layers`` if given), where every SSM gradient leaf
    (every leaf of a moe or encdec model, the router's, the encoder's and
    the cross-attention's included) is held to ``SSM_GRAD_REL_TOL``; then
    ``TRAIN_STEPS`` timed steps with every kernel's launches counted
    exactly, and one traced step (a moe step split into dispatch/combine,
    experts, attention and other). Returns the launches."""
    from repro_torch.bridge import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import _batch_for_step, stub_inputs
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (
        flash_attention_bwd_ref,
        flash_attention_ref,
        ssd_chunked_ref,
        ssd_scan_bwd_ref,
    )
    from repro_torch.launch import trace
    from repro_torch.launch.train_lm import DATA_SEED, loss_and_grads
    from repro_torch.models import LM
    from repro_torch.optim import adamw_init, adamw_update, cosine_schedule, global_norm

    t_phase = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
    label = f"train {arch}" + (f" layers={cfg.num_layers}" if layers else "")
    phase(label)
    torch.cuda.empty_cache()
    B, S = TRAIN_SHAPE[0], seq
    if why:
        print(f"  {cfg.num_layers} of {full.num_layers} layers: {why}")
    # the comparison steps run the chunked plain scan (the token-by-token
    # recurrence holds the kernel in the kernel phases), without remat: the
    # same values, and each plain scan once a block instead of twice
    plain_kw = dict(attention=flash_attention_ref, attention_bwd=flash_attention_bwd_ref,
                    ssd_scan=ssd_chunked_ref, ssd_scan_bwd=ssd_scan_bwd_ref)
    batches = [{**{key: torch.from_numpy(val).to(dev, torch.int64) for key, val in
                   _batch_for_step(DATA_SEED, step, B, S, cfg.vocab_size).items()},
                **{key: torch.from_numpy(val).to(dev) for key, val in
                   stub_inputs(cfg, B, DATA_SEED + step).items()}}
               for step in range(1 + TRAIN_STEPS)]

    def model(c):
        params = LM(c, device=dev).init(0, param_dtype=torch.float32)
        for _, t in named_leaves(params):
            t.requires_grad_(True)
        return LM(c, device=dev, remat=True), params

    if cfg.family == "hybrid":  # the flash backward at the shared block's shape
        gen = torch.Generator(device=dev).manual_seed(24)
        (q, k, v), _ = attention_inputs(torch, gen, dev, ZAMBA2_ATTN, "bfloat16")
        o = flash_attention_ref(q, k, v, causal=True)
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        got = ops.flash_attention_bwd(q, k, v, o, do, causal=True)
        checked = [compare(g, w, BF16_TOL) for g, w in
                   zip(got, flash_attention_bwd_ref(q, k, v, o, do, causal=True))]
        print(f"  flash backward at {ZAMBA2_ATTN} bfloat16 causal: max_abs_err dq/dk/dv "
              f"{' / '.join(f'{c[0]:.3g}' for c in checked)} (tol {BF16_TOL})")
        if not all(c[1] for c in checked):
            fail("the flash backward kernel disagrees with its plain version at zamba2-7b's "
                 "shared block")
        ZAMBA2_BWD.update(zamba2_bwd_times(torch, dev, fa, ops, trace, q, k, v, o, do))
        ZAMBA2_BWD["err"] = max(c[0] for c in checked)
        del q, k, v, o, do, got

    lm, params = model(cfg)
    stub_shapes = "".join(f" + {key} {tuple(x.shape)}" for key, x in batches[0].items()
                          if key not in ("tokens", "labels"))
    print(f"{cfg.name}: {count_params(params)} params (f32 master weights), compute "
          f"{cfg.dtype}, {cfg.num_layers} of {full.num_layers} layers, d_model {cfg.d_model}, "
          f"batch {B} x {S} tokens{stub_shapes}, remat per block")
    first = batches[0] if plain_rows is None else rows(batches[0], plain_rows)
    plain_loss, grads = loss_and_grads(LM(cfg, device=dev, **plain_kw), params, first)
    plain_loss, plain_gnorm = float(plain_loss), float(global_norm(grads))
    del grads
    loss, grads = loss_and_grads(lm, params, first)
    loss, gnorm = float(loss), float(global_norm(grads))
    if plain_rows is not None:  # the warm-up step on the whole batch
        del grads
        _, grads = loss_and_grads(lm, params, batches[0])
    opt = adamw_init(params)
    lr = cosine_schedule(3e-4, warmup=20, total=100)
    adamw_update(params, grads, opt, lr=lr)
    del grads
    rel_loss = abs(loss - plain_loss) / abs(plain_loss)
    plain_what = ("attention" if cfg.family in ("moe", "encdec", "vlm")
                  else "scan, scan backward and attention")
    print(f"  first step{f' on {plain_rows} row(s)' if plain_rows else ''}, kernels vs plain "
          f"{plain_what}: loss {loss:.6f} vs "
          f"{plain_loss:.6f} (rel {rel_loss:.3g}, tol {TRAIN_LOSS_REL_TOL}); grad norm "
          f"{gnorm:.6f} vs {plain_gnorm:.6f} (rel {abs(gnorm - plain_gnorm) / plain_gnorm:.3g})")
    if not (rel_loss <= TRAIN_LOSS_REL_TOL and finite(loss, gnorm)):
        fail(f"the first {arch} training step's loss disagrees with the plain kernels'")
    if cfg.is_moe:
        with torch.no_grad():
            _, metrics = lm.loss(params, batches[0])
        aux, xent = float(metrics["moe_aux"]), float(metrics["xent"])
        print(f"  moe_aux {aux:.6f} (summed over {cfg.num_layers} layers; 1 a layer when "
              f"balanced), xent {xent:.6f}, after the first update")
        if not (finite(aux) and aux > 0):
            fail(f"{arch}'s moe_aux {aux} is not finite and positive")

    counters = (ssd.ssd_scan, ssd.ssd_scan_bwd, *flash_counters(fa))
    for counter in counters:
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, losses = [], []
    for step in range(1, 1 + TRAIN_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(lm, params, batches[step])
        adamw_update(params, grads, opt, lr=lr)
        del grads
        torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = {counter.__name__: counter.launches for counter in counters}
    peak = torch.cuda.max_memory_allocated(dev)
    ms = statistics.median(step_ms)
    print(f"  steps {list(range(1, 1 + TRAIN_STEPS))}: loss "
          f"{', '.join(f'{x:.6f}' for x in losses)}; ms {', '.join(f'{x:.3f}' for x in step_ms)}")
    print(f"{label}: step_ms={ms:.3f} tok_per_s={B * S / ms * 1e3:.1f} "
          f"max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB) " +
          " ".join(f"{name}_launches_per_step={n / TRAIN_STEPS:g}"
                   for name, n in launches.items()))
    L = cfg.num_layers
    attn_blocks = {"moe": L, "vlm": L, "hybrid": L // max(cfg.hybrid_attn_period, 1),
                   "encdec": cfg.encoder_layers + 2 * L}.get(cfg.family, 0)
    ssd_blocks = L if cfg.family in ("ssm", "hybrid") else 0
    route = fa.route(torch.bfloat16, cfg.head_dim)
    want = {"ssd_scan": 2 * ssd_blocks, "ssd_scan_bwd": ssd_blocks,
            "flash_attention": 2 * attn_blocks,
            "flash_attention_wgmma": 2 * attn_blocks * (route == "wgmma"),
            "flash_attention_mma": 2 * attn_blocks * (route == "mma"),
            "flash_attention_wide": 0, **bwd_want(fa, attn_blocks, cfg.head_dim)}
    want = {name: n * TRAIN_STEPS for name, n in want.items()}
    if launches != want:
        fail(f"launches over {TRAIN_STEPS} {arch} training steps {launches}, want {want} (the "
             f"scan and the attention (self and cross) once a block and again in remat's "
             f"recompute, each backward once)")
    if not finite(*losses):
        fail(f"a {arch} training step's loss is not finite")

    def one_step():
        _, grads = loss_and_grads(lm, params, batches[-1])
        adamw_update(params, grads, opt, lr=lr)

    r = trace.traced(one_step, dev)
    trace.print_phase(f"{label}, one step traced", r, 1, 8)
    if cfg.is_moe:  # by range: kernels launched in the MoE layer's parts
        rng = r["by_range"]
        split = {"dispatch/combine": rng.get("moe.dispatch", 0) + rng.get("moe.combine", 0),
                 "experts": rng.get("moe.experts", 0),
                 "attention": r["by_kind"].get("flash_attention", 0)
                 + r["by_kind"].get("flash_attention_bwd", 0)}
        total = sum(r["by_kind"].values())
        split["other"] = total - sum(split.values())
        print(f"{label}, traced step by part: " + ", ".join(
            f"{name} {us / 1e3:.3f} ms ({us / total:.1%})" for name, us in split.items())
            + f" of {total / 1e3:.3f} ms of kernels")
    del lm, params, opt
    torch.cuda.empty_cache()
    if no_f32:
        print(f"  no f32 repeat: {no_f32}")
        print(f"{label}: phase took {time.perf_counter() - t_phase:.1f} s")
        return launches

    # the first step again in f32, where rounding does not hide a fault
    def f32_first_step(layers32: int) -> tuple:
        """(loss rel, {leaf: rel-L2}, moe: first-forward pairs to another
        expert by layer) of the first step in f32 at ``layers32`` layers."""
        cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=layers32)
        lm32, params32 = model(cfg32)
        plain32_lm = LM(cfg32, device=dev, **plain_kw)
        if cfg.is_moe:
            lm32.routes, plain32_lm.routes = [], []
        loss32, g_kernel = loss_and_grads(lm32, params32, batches[0])
        plain32, g_plain = loss_and_grads(plain32_lm, params32, batches[0])
        rel32 = abs(float(loss32) - float(plain32)) / abs(float(plain32))
        rels = {".".join(path): rel_l2(gk, gp) for (path, gk), (_, gp) in
                zip(named_leaves(g_kernel), named_leaves(g_plain))
                if cfg.family in ("moe", "encdec") or "ssd" in path}
        # remat's recompute appends a second set of routes: the forward's first
        flips = (routes_differ(lm32.routes[:layers32], plain32_lm.routes)[0]
                 if cfg.is_moe else None)
        del lm32, params32, plain32_lm, g_kernel, g_plain
        torch.cuda.empty_cache()
        return rel32, rels, flips

    def leaves(rels: dict) -> str:
        worst = max(rels, key=rels.get)
        return (", ".join(f"{path.removeprefix('layers.')} {rel:.3g}"
                          for path, rel in rels.items()
                          if path.startswith(("layers.", "enc_layers.")))
                + f"; worst {worst} {rels[worst]:.3g}")

    if cfg.is_moe:
        # at full depth the kernel and the plain attention's f32 summation
        # orders flip a few near-tie routes, and each flip reroutes that
        # token from there on: its gradient terms change whole. Printed; the
        # leaves are held at MOE_F32_GRAD_LAYERS, where no route differs
        rel_full, rels_full, flips_full = f32_first_step(L)
        print(f"  f32 first step at all {L} layers, kernels vs plain: loss rel {rel_full:.3g} "
              f"(tol {TRAIN_LOSS_REL_TOL}); pairs to another expert by layer {flips_full}; "
              f"gradient leaves, rel-L2 (not held at this depth): {leaves(rels_full)}")
        if not rel_full <= TRAIN_LOSS_REL_TOL:
            fail(f"the f32 {arch} training step's loss disagrees with the plain kernels'")
        f32_layers = MOE_F32_GRAD_LAYERS
    L32 = f32_layers or L
    if L32 != L:
        print(f"  f32 repeat at {L32} of the {L} layers")
    rel32, rels, flips = f32_first_step(L32)
    worst = max(rels.values())
    print(f"  f32 first step, kernels vs plain: loss rel {rel32:.3g}; "
          + (f"pairs to another expert by layer {flips} (must be 0); " if cfg.is_moe else "")
          + f"{'SSM' if 'ssd' in ''.join(rels) else 'every'} gradient leaf, rel-L2 (tol "
          f"{SSM_GRAD_REL_TOL}): {leaves(rels)}")
    if cfg.is_moe and sum(flips):
        fail(f"the f32 {arch} step at {L32} layers routes the kernels' forward unlike the "
             f"plain one's: its gradients cannot be compared leaf by leaf")
    if not (rel32 <= TRAIN_LOSS_REL_TOL and worst <= SSM_GRAD_REL_TOL):
        fail(f"the f32 {arch} training step's loss or a gradient leaf disagrees with "
             f"the plain kernels'")
    print(f"{label}: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def llava_train_layers(cfg, card_bytes: int) -> tuple[int, str]:
    """(N, why): the most of llava-next-34b's layers whose f32 weights,
    gradients and two AdamW moments (16 bytes a parameter) leave
    ``LLAVA_TRAIN_RESERVE`` bytes of the card for the rest."""
    outer = dataclasses.replace(cfg, num_layers=0).param_count()
    per_layer = dataclasses.replace(cfg, num_layers=1).param_count() - outer
    n = int((card_bytes - LLAVA_TRAIN_RESERVE - 16 * outer) // (16 * per_layer))
    why = (f"the most whose f32 weights, gradients and AdamW moments (16 bytes a parameter: "
           f"{16 * outer / 1e9:.2f} GB for the embedding and unembedding, "
           f"{16 * per_layer / 1e9:.2f} GB a layer) leave {LLAVA_TRAIN_RESERVE / 1e9:.0f} GB of "
           f"the card's {card_bytes / 1e9:.2f} GB for activations, AdamW's per-leaf "
           f"temporaries and the plain comparison")
    return n, why


def finite(*values) -> bool:
    return all(math.isfinite(x) for x in values)


# ---------------------------------------------------------------------------
# serving: each model at full width through its kernels, then its checks
# ---------------------------------------------------------------------------

def diagonal_dropped(scan):
    """``scan`` with a planted fault, an off-by-one causal mask: y_i leaves
    out its own position's term (C_i . B_i) dt_i x_i."""
    def faulty(xh, dt, A, Bm, Cm, *, chunk, return_state=False):
        out = scan(xh, dt, A, Bm, Cm, chunk=chunk, return_state=return_state)
        y = out[0] if return_state else out
        y = y - (Cm * Bm).sum(-1)[..., None, None] * dt[..., None] * xh
        return (y, out[1]) if return_state else y
    return faulty


def window_dropped(attention):
    """``attention`` with a planted fault: the sliding window left out, so
    every earlier key is visible."""
    def faulty(q, k, v, *, causal=True, window=0, softcap=0.0):
        return attention(q, k, v, causal=causal, softcap=softcap)
    return faulty


def kv_heads_rotated(attention):
    """``attention`` with a planted fault: the KV heads rotated by one, so
    every query head reads another group's keys and values (a wrong GQA
    head map)."""
    def faulty(q, k, v, **kw):
        return attention(q, k.roll(1, dims=2), v.roll(1, dims=2), **kw)
    return faulty


def card():
    """The card the serving phases run on."""
    import torch
    return torch.device("cuda", 0)


def scan_fault():
    """(what, LM keywords) of the planted fault the SSM logits checks must fail."""
    from repro_torch.kernels import ops
    return "off-by-one causal mask in the scan", dict(ssd_scan=diagonal_dropped(ops.ssd_scan))


def window_fault():
    """(what, LM keywords) of the planted fault the long-prompt checks must fail."""
    from repro_torch.kernels import ops
    return "sliding window left out", dict(attention=window_dropped(ops.flash_attention))


def gqa_fault():
    """(what, LM keywords) of the planted fault the moe and vlm logits checks
    must fail."""
    from repro_torch.kernels import ops
    return ("KV heads rotated by one (a wrong GQA head map)",
            dict(attention=kv_heads_rotated(ops.flash_attention)))


def bidirectional_made_causal(attention):
    """``attention`` with a planted fault: every non-causal self-attention
    (S = T: the encdec encoder's) run causally, so a frame sees only the
    frames before it; cross-attention (S != T) is left as it is."""
    def faulty(q, k, v, *, causal=True, **kw):
        return attention(q, k, v, causal=causal or q.shape[1] == k.shape[1], **kw)
    return faulty


def encoder_fault():
    """(what, LM keywords) of the planted fault the encdec logits checks must fail."""
    from repro_torch.kernels import ops
    return ("the encoder run causally",
            dict(attention=bidirectional_made_causal(ops.flash_attention)))


def rows(stub: dict, n: int) -> dict:
    return {name: x[:n] for name, x in stub.items()}


def routes_differ(a: list, b: list) -> tuple[list[int], list[int]]:
    """Between two runs' ``LM.routes``, by layer: the (token, choice) pairs
    whose expert differs, and those whose expert or queue slot differs. A
    token's choices are compared in expert order (their order among the
    top k moves no queue place); one expert that differs shifts the slots
    of every later pair in the queues of both experts."""
    def by_expert(idx, slot):
        order = idx.argsort(-1)
        return idx.gather(-1, order), slot.gather(-1, order)

    experts, routes = [], []
    for ra, rb in zip(a, b):
        (ia, sa), (ib, sb) = by_expert(*ra), by_expert(*rb)
        experts.append(int((ia != ib).sum()))
        routes.append(int(((ia != ib) | (sa != sb)).sum()))
    return experts, routes


def flash_want(fa, wgmma: int = 0, mma: int = 0) -> dict:
    """Launches a served prefill must count on each forward flash route, and
    none of the backward's."""
    return {fa.flash_attention: wgmma + mma, fa.flash_attention_wgmma: wgmma,
            fa.flash_attention_mma: mma, fa.flash_attention_wide: 0,
            **bwd_counters(fa, 0, 64)}


def logits_checks(cfg, lm, params, prompts, plain_kw: dict, tol: float,
                  out: dict | None = None, fault=None, stub: dict | None = None,
                  plain_rows: int | None = None) -> None:
    """Prefill logits against the same forward on the plain version(s), and
    decode at position P + S from the prefilled cache against a prefill of
    S+1 tokens, both by rel-L2. ``stub`` is the family's stub input
    (``frames`` or ``patches``, P of the latter ahead of the S tokens; P = 0
    without); the encdec's cache holds the cross k/v. The prefill logits
    and first token are the served run's ``out``, or a fresh prefill's
    without it. ``plain_rows``: the plain forward (and the fault's) on the
    first rows only, where the plain attention's dense f32 scores of every
    row do not fit beside the model. With ``fault`` (what, LM keywords that
    plant it), that forward must miss the plain one by more than ``tol``:
    the check can fail a wrong kernel. With patches, decode from position
    S (the patches left out of the count) must miss the longer prefill by
    more than ``tol``. In the moe
    family the (token, choice) routes that differ between the kernel and
    the plain prefill are counted by layer (the routed kernel prefill must
    repeat the served one's logits bit for bit); in the first layer, ahead
    of any route that differs, the share sent to another expert is held to
    ``MOE_FIRST_LAYER_ROUTES``, which the fault must exceed; and decode is
    checked at capacity factor E / k, where no choice drops
    (``MOE_BF16_REL_TOL``)."""
    import torch

    from repro_torch.launch.serve import prefix_len
    from repro_torch.models import LM

    dev = lm.device
    S = prompts.shape[1]
    stub = stub or {}
    P = prefix_len(stub)
    n = plain_rows or prompts.shape[0]
    with torch.inference_mode():
        plain = LM(cfg, device=dev, **plain_kw)
        plain.routes = [] if cfg.is_moe else None
        plain_logits = plain.prefill(params, prompts[:n], **rows(stub, n))[0]
        if out is None:
            got = lm.prefill(params, prompts, **stub)[0]
            tok0 = got.argmax(-1)
        else:
            got, tok0 = out["prefill_logits"], out["tokens"][:, 0]
        got_all, got = got, got[:n]
        if cfg.is_moe:
            lm.routes = []
            routed = lm.prefill(params, prompts)[0]
            kernel_routes, lm.routes = lm.routes, None
            if not torch.equal(routed, got_all):
                fail(f"{cfg.name} {cfg.dtype}: two kernel prefills gave different logits")
            experts, diff = routes_differ(kernel_routes, plain.routes)
            per_layer = kernel_routes[0][0].numel()
            pairs = per_layer * len(diff)
            print(f"  {cfg.dtype}: (token, choice) pairs of the kernel prefill routed to "
                  f"another expert than in the plain one, by layer: {experts}; to another "
                  f"expert or queue slot: {diff}; in all {sum(experts)} and {sum(diff)} of "
                  f"{pairs} ({sum(experts) / pairs:.3g}, {sum(diff) / pairs:.3g})")
            first = experts[0] / per_layer
            print(f"  {cfg.dtype}: first layer, pairs to another expert: {first:.3g} "
                  f"(tol {MOE_FIRST_LAYER_ROUTES})")
            if not first <= MOE_FIRST_LAYER_ROUTES:
                fail(f"{cfg.name} {cfg.dtype}: the first layer routes the kernel prefill "
                     f"unlike the plain one")
            del routed, kernel_routes
        plain_routes, plain.routes = plain.routes, None
        e_plain = rel_l2(got, plain_logits)
        with_stub = "".join(f" with {k} {tuple(x[:n].shape)}" for k, x in stub.items())
        print(f"  {cfg.dtype}, {tuple(prompts[:n].shape)} prompt{with_stub}: prefill vs plain "
              f"{'/'.join(plain_kw)}: rel_l2={e_plain:.3g} "
              f"max_abs={float((got - plain_logits).abs().max()):.3g} (tol rel_l2 {tol})")
        if not e_plain <= tol:
            fail(f"{cfg.name} {cfg.dtype} prefill logits disagree with the plain "
                 f"{'/'.join(plain_kw)} forward")
        if fault is not None:
            what, fault_kw = fault
            fault_lm = LM(cfg, device=dev, **fault_kw)
            fault_lm.routes = [] if cfg.is_moe else None
            faulty = fault_lm.prefill(params, prompts[:n], **rows(stub, n))[0]
            e_fault = rel_l2(faulty, plain_logits)
            print(f"  {cfg.dtype}: planted fault ({what}) vs plain: rel_l2={e_fault:.3g} "
                  f"(must exceed {tol})")
            if not e_fault > tol:
                fail(f"the {cfg.name} {cfg.dtype} prefill check passes a planted fault "
                     f"({what})")
            if cfg.is_moe:
                f_first = routes_differ(fault_lm.routes[:1], plain_routes[:1])[0][0] / per_layer
                print(f"  {cfg.dtype}: planted fault, first layer, pairs to another expert: "
                      f"{f_first:.3g} (must exceed {MOE_FIRST_LAYER_ROUTES})")
                if not f_first > MOE_FIRST_LAYER_ROUTES:
                    fail(f"the {cfg.name} {cfg.dtype} first-layer route check passes a "
                         f"planted fault ({what})")
            del faulty, fault_lm
        del plain_routes

        dec = lm
        if cfg.is_moe:
            dec = LM(dataclasses.replace(
                cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token), device=dev)
        _, cache = dec.prefill(params, prompts, max_seq=P + S + 1, **stub)
        step_logits = dec.decode_step(params, cache, tok0, P + S)[0]
        del cache
        longer = dec.prefill(params, torch.cat([prompts, tok0[:, None]], 1), **stub)[0]
        e_cache = rel_l2(step_logits, longer)
        print(f"  {cfg.dtype}: decode_step at {P + S} vs prefill of {S + 1}"
              f"{f' tokens after {P} patches' if P else ''}"
              f"{' (the cross cache from the prefill)' if 'frames' in stub else ''}"
              f"{f' at capacity factor {dec.cfg.capacity_factor:g}' if cfg.is_moe else ''}: "
              f"rel_l2={e_cache:.3g} max_abs={float((step_logits - longer).abs().max()):.3g} "
              f"(tol rel_l2 {tol})")
        if not e_cache <= tol:
            fail(f"{cfg.name} {cfg.dtype} decode from the prefilled cache disagrees with "
                 f"a longer prefill")
        if P:  # a decode that forgets the patches ahead of the prompt
            _, cache = dec.prefill(params, prompts, max_seq=P + S + 1, **stub)
            wrong = dec.decode_step(params, cache, tok0, S)[0]
            del cache
            e_wrong = rel_l2(wrong, longer)
            print(f"  {cfg.dtype}: decode_step at {S} (the patches left out of the position) "
                  f"vs prefill of {S + 1}: rel_l2={e_wrong:.3g} (must exceed {tol})")
            if not e_wrong > tol:
                fail(f"the {cfg.name} {cfg.dtype} decode check passes a decode at the wrong "
                     f"position")


def serve_counted(cfg, lm, params, prompts, want: dict,
                  stub: dict | None = None) -> tuple[dict, dict]:
    """Serve ``prompts`` (over the family's ``stub`` input) with every
    counter of ``want`` set to 0 just before the run and read just after;
    fail unless each counted ``want[counter]`` launches. Returns the served
    output and the counts."""
    import torch

    from repro_torch.launch.serve import report, serve

    dev = lm.device
    stub = stub or {}
    serve(lm, params, prompts, 2, **stub)  # warm-up: cuBLAS and allocator start-up
    for counter in want:
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    out = serve(lm, params, prompts, SERVE_NEW, **stub)
    launches = {counter: counter.launches for counter in want}
    peak = torch.cuda.max_memory_allocated(dev)
    print(report(out))
    print(f"serve {cfg.name} {cfg.dtype} layers={cfg.num_layers}: "
          f"prefill_ms={out['prefill_s'] * 1e3:.3f} "
          f"decode_ms_per_token={out['decode_s'] * 1e3 / SERVE_NEW:.3f} "
          f"decode_tok_per_s={SERVE_BATCH * SERVE_NEW / out['decode_s']:.1f} "
          f"max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB) " +
          " ".join(f"{c.__name__}_launches={n}" for c, n in launches.items()))
    for counter, n in want.items():
        if launches[counter] != n:
            fail(f"{counter.__name__} launched {launches[counter]} times in one "
                 f"{cfg.name} {cfg.dtype} serve of {cfg.num_layers} layers, want {n}")
    toks = out["tokens"]
    if toks.shape != (prompts.shape[0], SERVE_NEW + 1) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"bad generated tokens: shape {tuple(toks.shape)}")
    for key in ("prefill_logits", "last_logits"):
        if out[key].shape != (prompts.shape[0], cfg.vocab_size) or \
                out[key].dtype != torch.float32 or not torch.isfinite(out[key]).all():
            fail(f"{key}: want finite f32 [{prompts.shape[0]}, {cfg.vocab_size}]")
    return out, launches


def init_model(cfg):
    """``LM(cfg)`` on the card and its params from seed 0, with the peak
    memory of the init (each weight is cast as it is drawn)."""
    import torch

    from repro_torch.models import LM

    dev = card()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    lm = LM(cfg, device=dev)
    params = lm.init(0)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{cfg.name}: {count_params(params) / 1e9:.3f} B params, {cfg.dtype}, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}; init peak {peak} B "
          f"({peak / 2**30:.2f} GiB)")
    return lm, params


def check_serving(arch: str, want: dict, plain_kw: dict, rel_tol: float, *,
                  f32_tol: float | None = None, fault=None, want_f32: dict | None = None,
                  f32_layers: int | None = None, f32_why: str | None = None,
                  long_prompt: int | None = None, prompt_len: int = SERVE_PROMPT,
                  plain_rows: int | None = None) -> tuple[dict, dict | None]:
    """Serve ``arch`` at full width with its kernels' launches counted
    (``want``: counter -> launches the run must make), then the correctness
    checks, on ``SERVE_BATCH`` prompts of ``prompt_len`` tokens (over the
    family's seeded stub input: whisper's frames, llava's patches). With
    ``f32_tol`` the logits checks are repeated on the model in f32, where
    rounding does not hide a fault, at ``f32_layers`` of its layers if
    given (full width; ``f32_why`` says why the depth is cut), on a served
    f32 run counted like the first if ``want_f32`` is given; ``fault``
    plants a fault that the bf16 check must fail; ``plain_rows``: the plain
    forward on that many rows (``logits_checks``). ``long_prompt``: the
    checks again, in both dtypes, on one prompt of that many tokens, with
    the sliding window left out as the planted fault. Last, the reduced
    model on the card against the CPU. Returns the launches of the served
    runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import stub_inputs
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import LM

    t0 = time.perf_counter()
    phase(f"serve {arch}")
    dev = card()
    cfg = get_config(arch)
    lm, params = init_model(cfg)
    prompts = torch.from_numpy(
        make_prompts(SERVE_BATCH, prompt_len, cfg.vocab_size, 0)).to(dev)
    stub = to_device({name: torch.from_numpy(x) for name, x in
                      stub_inputs(cfg, SERVE_BATCH, 0).items()}, dev)
    long_prompts = None if long_prompt is None else torch.from_numpy(
        make_prompts(1, long_prompt, cfg.vocab_size, 2)).to(dev)
    out, launches = serve_counted(cfg, lm, params, prompts, want, stub)
    logits_checks(cfg, lm, params, prompts, plain_kw, rel_tol, out=out, fault=fault,
                  stub=stub, plain_rows=plain_rows)
    if long_prompts is not None:
        logits_checks(cfg, lm, params, long_prompts, plain_kw, rel_tol, fault=window_fault())
    del lm, params, out
    launches32 = None
    if f32_tol is not None:
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    num_layers=f32_layers or cfg.num_layers)
        if cfg32.num_layers != cfg.num_layers:
            print(f"  f32 repeat at full width and {cfg32.num_layers} of {cfg.num_layers} "
                  f"layers: the f32 weights of all {cfg.num_layers} "
                  f"({cfg.param_count() * 4 / 1e9:.1f} GB) do not fit the card"
                  + (f"; {f32_why}" if f32_why else ""))
        lm32, params32 = init_model(cfg32)
        out32 = None
        if want_f32 is not None:
            out32, launches32 = serve_counted(cfg32, lm32, params32, prompts, want_f32, stub)
        logits_checks(cfg32, lm32, params32, prompts, plain_kw, f32_tol, out=out32,
                      stub=stub, plain_rows=plain_rows)
        if long_prompts is not None:
            logits_checks(cfg32, lm32, params32, long_prompts, plain_kw, f32_tol,
                          fault=window_fault())
        del lm32, params32, out32
    torch.cuda.empty_cache()

    with torch.inference_mode():
        small = cfg.reduced(dtype="float32", **(HYBRID_TAIL if cfg.family == "hybrid" else {}))
        cpu_lm, gpu_lm = LM(small, device="cpu"), LM(small, device=dev)
        cpu_params = cpu_lm.init(0)
        gpu_params = to_device(cpu_params, dev)
        small_tokens = torch.from_numpy(make_prompts(2, 100, small.vocab_size, 1))
        small_stub = {name: torch.from_numpy(x) for name, x in stub_inputs(small, 2, 1).items()}
        want_small = cpu_lm.forward_logits(cpu_params, small_tokens, **small_stub)
        got = gpu_lm.forward_logits(gpu_params, small_tokens.to(dev),
                                    **to_device(small_stub, dev)).cpu()
        e_small, ok = compare(got, want_small, REDUCED_F32_TOL)
        print(f"  reduced f32 model ({small.num_layers} layers; its kernels at the reduced "
              f"shape), card vs CPU: max_abs_err={e_small:.3g} (rtol = atol = {REDUCED_F32_TOL})")
        if not ok:
            fail(f"the reduced {arch} on the card disagrees with the CPU")
    print(f"serve {arch}: phase took {time.perf_counter() - t0:.1f} s")
    return launches, launches32


def serving_phases(fa, ssd, flash_attention_ref, ssd_scan_ref) -> None:
    """The hybrid zamba2-7b and the three dense configs beyond llama3.2-1b,
    each at full width and depth in bf16 (every attention call on the wgmma
    route) and again in f32 (the mma route; internlm2-20b's f32 at
    ``INTERNLM2_F32_LAYERS`` layers)."""
    from repro_torch.configs import get_config

    z = get_config("zamba2-7b")
    groups = z.num_layers // z.hybrid_attn_period
    scans = {ssd.ssd_scan: z.num_layers}
    check_serving("zamba2-7b", {**flash_want(fa, wgmma=groups), **scans},
                  dict(attention=flash_attention_ref, ssd_scan=ssd_scan_ref),
                  HYBRID_BF16_REL_TOL, f32_tol=HYBRID_F32_REL_TOL, fault=scan_fault(),
                  want_f32={**flash_want(fa, mma=groups), **scans})
    for arch in ("chatglm3-6b", "internlm2-20b", "h2o-danube-3-4b"):
        L = get_config(arch).num_layers
        L32 = INTERNLM2_F32_LAYERS if arch == "internlm2-20b" else L
        check_serving(arch, flash_want(fa, wgmma=L), dict(attention=flash_attention_ref),
                      LOGITS_REL_TOL, f32_tol=LLAMA_F32_REL_TOL,
                      want_f32=flash_want(fa, mma=L32), f32_layers=L32,
                      long_prompt=WINDOW_PROMPT if get_config(arch).sliding_window else None)


def moe_serving_phases(fa, flash_attention_ref) -> None:
    """granite-moe-1b-a400m and granite-moe-3b-a800m at full width and depth
    in bf16 (the wgmma route) and again in f32 (the mma route), a planted
    GQA fault that the bf16 check must fail."""
    from repro_torch.configs import get_config

    for arch in MOE_ARCHS:
        L = get_config(arch).num_layers
        check_serving(arch, flash_want(fa, wgmma=L), dict(attention=flash_attention_ref),
                      MOE_BF16_REL_TOL, f32_tol=LLAMA_F32_REL_TOL, fault=gqa_fault(),
                      want_f32=flash_want(fa, mma=L))


def encdec_vlm_serving_phases(fa, flash_attention_ref) -> None:
    """whisper-medium at full width and depth in bf16 (the wgmma route: 72
    launches a prefill, the encoder's 24, the decoder's 24 self- and 24
    cross-attention) and f32 (the mma route), the encoder run causally as
    the planted fault; llava-next-34b at full width and all 60 layers in
    bf16 (60 wgmma launches a prefill) and at ``LLAVA_F32_LAYERS`` in f32,
    the plain forward on one row, the GQA fault, and decode at the wrong
    position."""
    from repro_torch.configs import get_config

    w = get_config("whisper-medium")
    whisper = w.encoder_layers + 2 * w.num_layers
    check_serving("whisper-medium", flash_want(fa, wgmma=whisper),
                  dict(attention=flash_attention_ref), ENCDEC_BF16_REL_TOL,
                  f32_tol=LLAMA_F32_REL_TOL, fault=encoder_fault(),
                  want_f32=flash_want(fa, mma=whisper), prompt_len=WHISPER_PROMPT)
    L = get_config("llava-next-34b").num_layers
    check_serving("llava-next-34b", flash_want(fa, wgmma=L), dict(attention=flash_attention_ref),
                  VLM_BF16_REL_TOL, f32_tol=LLAMA_F32_REL_TOL, fault=gqa_fault(),
                  want_f32=flash_want(fa, mma=LLAVA_F32_LAYERS), f32_layers=LLAVA_F32_LAYERS,
                  f32_why=LLAVA_F32_WHY, plain_rows=1)


def dp_phase(torch, dev, fa) -> None:
    """train_lm's data-parallel step with ``DP_RANKS`` ranks stacked on the
    card, PCCL beside the built-in reduction from the same params on the
    same batches. The trainer checks each step that every rank's all-reduced
    vector and params are equal bit for bit, and raises if not."""
    from repro_torch.data.pipeline import _batch_for_step
    from repro_torch.launch import trace, train_lm

    phase(f"data-parallel step, {DP_RANKS} ranks stacked")
    torch.cuda.empty_cache()
    cfg = train_lm.model_config(DP_MODEL)
    counters = flash_counters(fa)
    for counter in counters:
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    out = train_lm.train(cfg, steps=DP_STEPS, batch=DP_BATCH, seq=DP_SEQ, dp=DP_RANKS,
                         compare=True, device=dev)
    launches = {counter.__name__: counter.launches for counter in counters}
    peak = torch.cuda.max_memory_allocated(dev)
    for name in train_lm.COLLECTIVES:
        run = out[name]
        if not (run["trainer"].replicas_equal() and finite(*run["loss"])):
            fail(f"{name}: the ranks' params differ or a loss is not finite")
        ms = statistics.median(run["step_ms"][1:])
        print(f"dp {name}: model {DP_MODEL} ({cfg.param_count()} params), {DP_RANKS} ranks "
              f"stacked, global batch {DP_BATCH} x {DP_SEQ}: step_ms "
              f"{', '.join(f'{x:.3f}' for x in run['step_ms'])} (median after the first "
              f"{ms:.3f}, {DP_BATCH * DP_SEQ / ms * 1e3:.1f} tok/s); ranks' params equal bit "
              f"for bit after every step")
    print(f"dp: max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB) " +
          " ".join(f"{name}_launches={n}" for name, n in launches.items()))
    layers = cfg.num_layers * DP_RANKS * DP_STEPS * len(train_lm.COLLECTIVES)
    route = fa.route(getattr(torch, cfg.dtype), cfg.head_dim)
    want = {"flash_attention": 2 * layers,
            **{f"flash_attention_{r}": 2 * layers * (r == route) for r in ("wgmma", "mma", "wide")},
            **bwd_want(fa, layers, cfg.head_dim, cfg.dtype)}
    if launches != want:
        fail(f"flash launches in the data-parallel runs {launches}, want {want} (the forward "
             f"twice a layer, remat's recompute the second, the backward once)")
    if not (out["max_loss_diff"] < DP_LOSS_TOL and out["max_param_diff"] < DP_PARAM_TOL):
        fail(f"PCCL and the built-in all-reduce diverge beyond {DP_LOSS_TOL} (loss) or "
             f"{DP_PARAM_TOL} (params)")
    # one more PCCL step under the profiler: where a step's time goes
    batch = {key: torch.from_numpy(val).to(dev, torch.int64) for key, val in
             _batch_for_step(train_lm.DATA_SEED, DP_STEPS, DP_BATCH, DP_SEQ,
                             cfg.vocab_size).items()}
    trainer = out["pccl"]["trainer"]
    trace.print_phase(f"dp pccl, {DP_RANKS} ranks stacked, one step traced",
                      trace.traced(lambda: trainer.step(batch), dev), 1, 8)
    del out, trainer
    torch.cuda.empty_cache()


def compression_phase(torch, dev) -> dict:
    """The compressed all-reduce of ``comms.compression`` on the card: a
    gradient tree with the shapes of train_lm's ``COMPRESS_MODEL``,
    ``COMPRESS_RANKS`` ranks stacked, rank r's leaves drawn N(0, 1) x
    2^(r - 4) from a seeded card generator, with residuals at 1e-2 of that.
    Per leaf and rank, ``ef_int8_compress``'s q, scale and residual equal
    the same function's on the CPU bit for bit, and
    ``error_feedback_all_reduce``'s residual row equals it (each rank its
    own scale); the mean within the quantization bound sum_r scale_r /
    (2 dp) of the uncompressed mean, not bit-equal to it; 50 error-feedback
    steps on one leaf. Then both means timed by CUDA events beside their
    bytes' bound. Returns the times."""
    from repro_torch.bridge import named_leaves
    from repro_torch.comms.compression import (
        ef_int8_compress,
        ef_int8_decompress,
        error_feedback_all_reduce,
    )
    from repro_torch.launch import train_lm
    from repro_torch.models import LM

    t_phase = time.perf_counter()
    phase("compression")
    torch.cuda.empty_cache()
    dp = COMPRESS_RANKS
    cfg = train_lm.model_config(COMPRESS_MODEL)
    shapes = [(path, tuple(t.shape)) for path, t in
              named_leaves(LM(cfg, device=dev).init(0, param_dtype=torch.float32))]
    gen = torch.Generator(device=dev).manual_seed(29)
    mag = 2.0 ** (torch.arange(dp, device=dev, dtype=torch.float32) - 4)
    grads, res = {}, {}
    for path, shape in shapes:
        m = mag.reshape(dp, *[1] * len(shape))
        name = ".".join(path)
        grads[name] = torch.randn((dp, *shape), generator=gen, device=dev) * m
        res[name] = torch.randn((dp, *shape), generator=gen, device=dev) * (m * 1e-2)
    n = sum(math.prod(shape) for _, shape in shapes)
    nbytes = n * dp * 4
    print(f"{COMPRESS_MODEL}'s gradient tree: {len(shapes)} leaves, {n} f32 a rank, {dp} ranks "
          f"stacked: {nbytes} B ({nbytes / 1e9:.2f} GB) of gradients, as much of residuals")
    torch.cuda.reset_peak_memory_stats(dev)
    mean, new_res = error_feedback_all_reduce(grads, res)
    torch.cuda.synchronize(dev)

    # per leaf and rank: the card's compress against the CPU's, bit for bit
    t0 = time.perf_counter()
    worst_bound, scales = 0.0, []
    for name in grads:
        g, r = grads[name], res[name]
        for rank in range(dp):
            q, scale, nr = ef_int8_compress(g[rank], r[rank])
            cq, cscale, cnr = ef_int8_compress(g[rank].cpu(), r[rank].cpu())
            if not (torch.equal(q.cpu(), cq) and torch.equal(scale.cpu(), cscale)
                    and torch.equal(nr.cpu(), cnr)):
                fail(f"ef_int8_compress of {name} rank {rank}: the card's q, scale or "
                     f"residual differ from the CPU's")
            if not torch.equal(new_res[name][rank], nr):
                fail(f"error_feedback_all_reduce's residual of {name} rank {rank} is not "
                     f"ef_int8_compress's of that rank alone")
            scales.append(float(scale))
        acc = g + r
        rank_scales = acc.abs().reshape(dp, -1).amax(1) / 127.0
        want = acc.sum(0) / dp
        err = float((mean[name][0] - want).abs().max())
        # f32 slack: the dp-term sums of either side, a few ulps of sum_r |acc_r|
        slack = 1e-6 * float(acc.abs().reshape(dp, -1).amax(1).sum())
        bound = float(rank_scales.sum()) / (2 * dp)
        worst_bound = max(worst_bound, err / bound)
        if not err <= bound + slack:
            fail(f"the compressed mean of {name} is {err:.3g} from the uncompressed one, over "
                 f"the quantization bound {bound:.3g} + {slack:.3g}")
        if torch.equal(mean[name][0], want):
            fail(f"the compressed mean of {name} equals the uncompressed one bit for bit: "
                 f"nothing was compressed")
        if not all(torch.equal(mean[name][rank], mean[name][0]) for rank in range(dp)):
            fail(f"the ranks' means of {name} differ")
        del acc, want
    print(f"  q, scale and residual of every leaf and rank equal the CPU's bit for bit "
          f"({time.perf_counter() - t0:.1f} s); scales by rank of the last leaf "
          f"{', '.join(f'{x:.3g}' for x in scales[-dp:])}; mean within "
          f"{worst_bound:.3g} of the quantization bound at worst, never bit-equal")
    del mean, new_res

    # error feedback: 50 steps on one leaf of rank 4 (scale 1); the totals
    # in f64, so that the drift is the compression's, not the sums'
    name = max(grads, key=lambda k: grads[k][0].numel())
    g = grads[name][4]
    r = torch.zeros_like(g)
    total_in = torch.zeros_like(g, dtype=torch.float64)
    total_out = torch.zeros_like(total_in)
    for _ in range(DRIFT_STEPS):
        q, scale, r = ef_int8_compress(g, r)
        total_in += g
        total_out += ef_int8_decompress(q, scale)
    drift = float((total_out + r - total_in).abs().max())
    print(f"  {DRIFT_STEPS} error-feedback steps on {name} rank 4 ({g.numel()} f32): drift "
          f"{drift:.3g} (tol {DRIFT_TOL})")
    if not drift < DRIFT_TOL:
        fail(f"error feedback drifts {drift:.3g} over {DRIFT_STEPS} steps")
    del g, r, total_in, total_out

    leaves = list(grads.values())
    fns = {"compressed": lambda: error_feedback_all_reduce(grads, res),
           "uncompressed": lambda: [x.sum(0) / dp for x in leaves]}
    times = time_pair(torch, fns, 3)
    peak = torch.cuda.max_memory_allocated(dev)
    mean_bytes = n * 4
    moved = {"compressed": 3 * nbytes + mean_bytes,  # g, r read; residual, mean written
             "uncompressed": nbytes + mean_bytes}
    for key, ms in times.items():
        bound_ms = moved[key] / PEAK_BYTES * 1e3
        print(f"compression {key}: {ms:.3f} ms a call of the whole tree; reads and writes "
              f"{moved[key]} B ({moved[key] / 1e9:.2f} GB), bound {bound_ms:.3f} ms at "
              f"{PEAK_BYTES / 1e12:.2f} TB/s ({ms / bound_ms:.2f}x)")
    print(f"compression: max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB); phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    del grads, res, leaves, fns
    torch.cuda.empty_cache()
    return times


def fmt_ms(values) -> str:
    return ", ".join(f"{x:.3f}" for x in values)


class CountingCheckpointer:
    """A checkpointer whose restores are counted, as tests/test_repair.py's
    ``_FakeCheckpointer`` counts them: a recovery that must fail first
    must leave the count at 0."""

    def __init__(self, inner):
        self.inner, self.restores = inner, 0

    def restore(self, template, **kw):
        self.restores += 1
        return self.inner.restore(template, **kw)


def checkpoint_resume(torch, dev, cfg, batch: int, seq: int, ckpt_dir: str,
                      counters=()) -> dict:
    """(a) at any size, through ``train_lm.train`` at dp 1: run U takes
    CKPT_STEPS steps; run C stops one short, saving the state after
    CKPT_LABEL updates as label CKPT_LABEL in ``ckpt_dir`` (its write goes
    on while the next step runs); run R resumes from it and runs to
    CKPT_STEPS, writing nothing. Fails unless C's and R's losses are within
    RESUME_RTOL of U's and R restored label CKPT_LABEL holding AdamW step
    CKPT_LABEL. ``counters``' launches are counted over R alone."""
    from repro_torch.bridge import named_leaves
    from repro_torch.launch import train_lm

    def run(steps, **kw):
        return train_lm.train(cfg, steps=steps, batch=batch, seq=seq, collectives="builtin",
                              device=dev, log=lambda line: None, **kw)["builtin"]

    u = run(CKPT_STEPS)
    u_params = u.pop("trainer").replicas[0]
    c = run(CKPT_STEPS - 1, ckpt_dir=ckpt_dir, ckpt_every=CKPT_LABEL)
    del c["trainer"]
    (save,) = c["saves"]
    for counter in counters:
        counter.launches = 0
    r = run(CKPT_STEPS, ckpt_dir=ckpt_dir, ckpt_every=CKPT_STEPS + 1, resume=True)
    launches = {counter.__name__: counter.launches for counter in counters}
    restored = r["restored"]
    if not (save["step"] == CKPT_LABEL and restored is not None
            and restored["step"] == restored["opt_step"] == r["start_step"] == CKPT_LABEL):
        fail(f"resume: saved {save}, restored {restored}, started at {r['start_step']}: "
             f"want label {CKPT_LABEL} holding AdamW step {CKPT_LABEL}, resumed there")
    want_c, want_r = u["loss"][:CKPT_STEPS - 1], u["loss"][CKPT_LABEL:]
    for name, got, want in (("C", c["loss"], want_c), ("R", r["loss"], want_r)):
        if not (finite(*got) and len(got) == len(want) and all(
                abs(a - b) <= RESUME_RTOL * abs(b) for a, b in zip(got, want))):
            fail(f"run {name}'s losses {got} miss the uninterrupted run's {want} "
                 f"(rtol {RESUME_RTOL})")
    r_params = r["trainer"].replicas[0]
    return {"u": u, "c": c, "r": r, "save": save, "restored": restored,
            "bytes": sum(f.stat().st_size for f in
                         (Path(ckpt_dir) / f"step_{CKPT_LABEL:08d}").iterdir()),
            "launches": launches,
            "losses_bit_equal": c["loss"] == want_c and r["loss"] == want_r,
            "params_bit_equal": all(torch.equal(a, b) for (_, a), (_, b) in zip(
                named_leaves(r_params), named_leaves(u_params))),
            "max_param_diff": train_lm.max_abs_diff(r_params, u_params)}


def elastic_recovery(torch, dev, cfg, batch: int, seq: int, ckpt_dir: str) -> dict:
    """(b) and (c) at any size, PCCL through ``train_lm.train``: U8 takes
    CKPT_STEPS steps on ELASTIC_RANKS ranks stacked; C8 takes CKPT_LABEL
    and saves label CKPT_LABEL. The reference's recovery loop, built from
    the port's modules with the data-parallel all-reduce registered, loses
    ELASTIC_DEAD: it must repair the all-reduce for the survivors (valid,
    no transfer on a dead NPU) and restore label CKPT_LABEL onto a mesh of
    the survivors; R7 resumes from that state on a data-parallel run of
    that size. A second recovery loses SPLIT_DEAD, which splits the ring:
    it must raise FabricDegradedError before any restore. Returns the
    runs, the repair and the refusal."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import DegradationEvent, FabricDegradedError, PlanService
    from repro_torch.launch import train_lm
    from repro_torch.runtime import ElasticMeshPlanner, FaultToleranceManager
    from repro_torch.topology import ring

    def run(dp, steps, **kw):
        return train_lm.train(cfg, steps=steps, batch=batch, seq=seq, dp=dp,
                              collectives="pccl", device=dev, log=lambda line: None,
                              **kw)["pccl"]

    u8 = run(ELASTIC_RANKS, CKPT_STEPS)
    u8_params = u8.pop("trainer").replicas[0]
    trainer = run(ELASTIC_RANKS, CKPT_LABEL, ckpt_dir=ckpt_dir,
                  ckpt_every=CKPT_LABEL)["trainer"]
    template = {"params": trainer.replicas[0], "opt": trainer.opts[0]}

    def manager():
        ftm = FaultToleranceManager(
            checkpointer=CountingCheckpointer(Checkpointer(ckpt_dir)),
            planner=ElasticMeshPlanner(model_degree=1), make_mesh=lambda data, model: data,
            plan_service=PlanService(), topology=ring(ELASTIC_RANKS, bidirectional=True))
        ftm.register_collective(trainer.mean.req)  # the data-parallel all-reduce
        return ftm

    ftm, event = manager(), DegradationEvent(failed_npus=ELASTIC_DEAD)
    t0 = time.perf_counter()
    step, state, mesh = ftm.recover(template, surviving_chips=ELASTIC_RANKS - len(ELASTIC_DEAD),
                                    shardings_for_mesh=lambda mesh: {"params": dev, "opt": dev},
                                    degradation=event)
    recover_s = time.perf_counter() - t0
    survivors = tuple(d for d in range(ELASTIC_RANKS) if d not in ELASTIC_DEAD)
    if not (step == CKPT_LABEL and mesh == len(survivors) and state["opt"].step == CKPT_LABEL
            and ftm.checkpointer.restores == 1 and len(ftm.replanned) == 1):
        fail(f"recover(): step {step}, mesh {mesh}, AdamW step {state['opt'].step}, "
             f"{ftm.checkpointer.restores} restores, {len(ftm.replanned)} repaired "
             f"collectives: want step and AdamW step {CKPT_LABEL}, mesh {len(survivors)}, one "
             f"restore, one repaired all-reduce")
    (res,) = ftm.replanned.values()
    res.algorithm.validate()
    if tuple(res.request.group) != survivors:
        fail(f"the repaired all-reduce's group {res.request.group}, want {survivors}")
    if used := failed_parts_used(res.algorithm, res.view, event):
        fail(f"the repaired all-reduce sends over the failed {', '.join(used)}")

    split = manager()
    try:
        split.recover(template, ELASTIC_RANKS - len(SPLIT_DEAD), lambda mesh: {},
                      degradation=DegradationEvent(failed_npus=SPLIT_DEAD))
        fail(f"NPUs {SPLIT_DEAD} failed: the recovery returned, where the ring is split")
    except FabricDegradedError as e:
        refused = str(e)
    if split.checkpointer.restores or split.plan_service.metrics()["repair_failures"] != 1:
        fail(f"NPUs {SPLIT_DEAD} failed: {split.checkpointer.restores} restores and "
             f"{split.plan_service.metrics()['repair_failures']} repair failures, want 0 and 1")
    del trainer, template

    r7 = run(mesh, CKPT_STEPS, params=state["params"], opt=state["opt"])
    del state
    want = u8["loss"][CKPT_LABEL:]
    if not (finite(*r7["loss"]) and len(r7["loss"]) == len(want)):
        fail(f"R7's losses {r7['loss']}, want {len(want)} finite ones")
    return {"u8": u8, "r7": r7, "res": res, "event": event, "recover_s": recover_s,
            "refused": refused,
            "max_loss_diff": max(abs(a - b) for a, b in zip(r7["loss"], want)),
            "max_param_diff": train_lm.max_abs_diff(r7["trainer"].replicas[0], u8_params)}


def checkpoint_phase(torch, dev, fa, smi_line: str) -> None:
    """Checkpoint/resume of full-width llama3.2-1b (``checkpoint_resume``)
    with its flash launches counted, then the elastic recovery of
    train_lm's ELASTIC_MODEL (``elastic_recovery``) with its repaired
    all-reduce run at the gradient vector's size. Each writes its
    checkpoints under a new temporary directory, deleted at the end."""
    import shutil
    import tempfile

    from repro_torch.comms import executor, primitives
    from repro_torch.configs import get_config
    from repro_torch.launch import train_lm

    phase("checkpoint and recovery")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config("llama3.2-1b")
    B, S = TRAIN_SHAPE[:2]
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free, need = shutil.disk_usage(ckpt_dir).free, 12 * cfg.param_count()
        print(f"  {ckpt_dir}: {free} B free ({free / 1e9:.1f} GB); one checkpoint of "
              f"{cfg.name} (f32 params, AdamW mu and nu) takes ~{need / 1e9:.1f} GB")
        if free < need:
            fail(f"{free} B free under {ckpt_dir}, a checkpoint needs {need}")
        a = checkpoint_resume(torch, dev, cfg, B, S, ckpt_dir, flash_counters(fa))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    L, R = cfg.num_layers, CKPT_STEPS - CKPT_LABEL
    want = {"flash_attention": 2 * L * R, "flash_attention_wgmma": 2 * L * R,
            "flash_attention_mma": 0, "flash_attention_wide": 0,
            **bwd_want(fa, L * R, cfg.head_dim, cfg.dtype)}
    if a["launches"] != want:
        fail(f"flash launches over the resumed run's {R} steps {a['launches']}, want {want}")
    u, c, r, save = a["u"], a["c"], a["r"], a["save"]
    print(f"  {cfg.name}, batch {B} x {S}, f32 master weights and AdamW state: U "
          f"{CKPT_STEPS} steps, C {CKPT_STEPS - 1} saving label {CKPT_LABEL} after step "
          f"{CKPT_LABEL - 1}, R resumed from it: restored step {a['restored']['step']}, "
          f"AdamW step {a['restored']['opt_step']}")
    print(f"  losses: U {u['loss']}; C {c['loss']}; R {r['loss']}: within rtol {RESUME_RTOL} "
          f"of U's; bit-equal to U's: losses {a['losses_bit_equal']}, R's final params "
          f"{a['params_bit_equal']} (max abs diff {a['max_param_diff']:.3g})")
    print(f"  checkpoint {a['bytes']} B ({a['bytes'] / 1e9:.2f} GB); save() returned in "
          f"{save['save_s']:.3f} s (the snapshot to host memory), the write took "
          f"{save['write_s']:.3f} s after; restore {a['restored']['restore_s']:.3f} s; "
          f"step {CKPT_LABEL} ms with the write in flight {c['step_ms'][CKPT_LABEL]:.3f} "
          f"beside U's {u['step_ms'][CKPT_LABEL]:.3f} (step ms U {fmt_ms(u['step_ms'])}; "
          f"C {fmt_ms(c['step_ms'])}; R {fmt_ms(r['step_ms'])}); R's flash launches "
          f"{a['launches']}; {smi_line}")
    summary = (f"checkpoint: bytes={a['bytes']} save_s={save['save_s']:.3f} "
               f"write_s={save['write_s']:.3f} restore_s={a['restored']['restore_s']:.3f} "
               f"resumed_losses_bit_equal={a['losses_bit_equal']} "
               f"resumed_params_bit_equal={a['params_bit_equal']}")
    del a, u, c, r
    torch.cuda.empty_cache()

    # f32 compute: in bf16 each rank's weight gradients are rounded to bf16
    # over the rows it holds, so 7 and 8 rows a rank round apart, and AdamW
    # turns near-zero gradients that differ in sign into whole steps
    ecfg = dataclasses.replace(train_lm.model_config(ELASTIC_MODEL), dtype="float32")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        b = elastic_recovery(torch, dev, ecfg, ELASTIC_BATCH, ELASTIC_SEQ, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    res = b["res"]
    group = tuple(res.request.group)
    prog = primitives.lower_algorithm(res.algorithm, key="elastic")
    D = ecfg.param_count() + 1  # the gradient vector and the loss
    W = D - D % math.lcm(len(group), ELASTIC_RANKS)
    x = torch.randn((ELASTIC_RANKS, W), generator=torch.Generator(device=dev).manual_seed(7),
                    device=dev)
    x[list(ELASTIC_DEAD)] = float("nan")
    out = check_all_reduce(torch, x, None, res.request, "elastic, repaired", program=prog)
    if not bool(torch.isfinite(out).all()):
        fail("the repaired all-reduce's output is not finite")
    del out
    ar_ms = statistics.median(time_ms(torch, lambda: primitives.pccl_all_reduce(
        x, None, res.request, program=prog), 3) for _ in range(3))
    dead = ", ".join(map(str, ELASTIC_DEAD))
    print(f"  elastic: {ELASTIC_MODEL} ({ecfg.param_count()} params, f32), PCCL, {ELASTIC_RANKS} "
          f"ranks stacked, global batch {ELASTIC_BATCH} x {ELASTIC_SEQ}; NPU {dead} "
          f"failed: recover() took {b['recover_s']:.3f} s, restored label {CKPT_LABEL} onto "
          f"a mesh of {len(group)}; the all-reduce repaired by {res.strategy} over {group}: "
          f"{prog[0].num_rounds} rounds, {prog[0].num_sends} sends, valid, no transfer "
          f"touches NPU {dead}; at {W} f32 a rank, NPU {dead}'s row NaN in: "
          f"{ar_ms:.3f} ms a call (median of 3 rounds of 3, CUDA events)")
    print(f"  resumed at dp = {len(group)} (a fresh ring of {len(group)}): losses "
          f"{b['r7']['loss']} against the uninterrupted dp = {ELASTIC_RANKS} run's "
          f"{b['u8']['loss'][CKPT_LABEL:]}: max diff {b['max_loss_diff']:.3g} (tol "
          f"{DP_LOSS_TOL}), params {b['max_param_diff']:.3g} (tol {DP_PARAM_TOL}); step ms "
          f"dp = {ELASTIC_RANKS} {fmt_ms(b['u8']['step_ms'])}, dp = {len(group)} "
          f"{fmt_ms(b['r7']['step_ms'])}")
    if not (b["max_loss_diff"] < DP_LOSS_TOL and b["max_param_diff"] < DP_PARAM_TOL):
        fail(f"the dp = {len(group)} run resumed from the checkpoint diverges from the "
             f"uninterrupted dp = {ELASTIC_RANKS} run beyond {DP_LOSS_TOL} (loss) or "
             f"{DP_PARAM_TOL} (params)")
    print(f"  NPUs {' and '.join(map(str, SPLIT_DEAD))} failed: FabricDegradedError "
          f"({b['refused']}) before any restore; repair_failures 1")
    del x, prog, b
    executor.clear_plan_cache()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{summary} recovery={res.strategy} ranks={len(group)} "
          f"repaired_all_reduce_ms={ar_ms:.3f} max_memory_allocated={peak} B "
          f"({peak / 2**30:.2f} GiB)")
    print(f"checkpoint and recovery: phase took {time.perf_counter() - t_phase:.1f} s")


def gathered_exactly(torch, out, x, group) -> bool:
    """Whether the stacked All-Gather output ``out`` [n, g, *S] holds the
    rows of ``x`` [n, *S] of ``group``, in group order, at each member, and
    exact zeros at every other rank, bit for bit."""
    want = x[list(group)].view(torch.uint8)
    for d in range(out.shape[0]):
        got = out[d].view(torch.uint8)
        if not (torch.equal(got, want) if d in group else not bool(got.any())):
            return False
    return True


def last_round_dropped(prog):
    """A planted fault: (``prog`` without its last round, its buffer plan)."""
    from repro_torch.comms import plan_buffers
    from repro_torch.core.translate import PpermuteProgram

    cut = PpermuteProgram(prog.num_devices, prog.rounds[:-1], dict(prog.chunk_holders),
                          dict(prog.chunk_dests))
    return cut, plan_buffers(cut)


def quickstart_gather_checks(torch, dev) -> None:
    """quickstart's All-Gather over group (0, 3, 12) of the 4x4 mesh, NPU d
    holding d + 1, on 16 ranks stacked on ``dev``: NPU 0 gathers
    ``QUICKSTART_GATHERED``, every member the members' inputs in group
    order and the 13 other NPUs exact zeros, bit for bit, and the numpy
    round interpreter's bits; the same program with its last round dropped
    must fail the check."""
    import numpy as np

    from repro_torch.comms import interpret_collective, pccl_all_gather, synthesize_program
    from repro_torch.core import CollectiveRequest
    from repro_torch.examples.quickstart import GROUP
    from repro_torch.topology import mesh2d

    topo = mesh2d(4, 4)
    req = CollectiveRequest("all_gather", group=GROUP)
    n = len(topo.npus)
    x = (torch.arange(n, dtype=torch.float32, device=dev) + 1.0)[:, None]
    out = pccl_all_gather(x, topo, req)
    got = out.cpu().numpy()
    interp = interpret_collective("all_gather", x.cpu().numpy(), topo, req)
    if got[GROUP[0], :, 0].tolist() != QUICKSTART_GATHERED:
        fail(f"quickstart's All-Gather: NPU {GROUP[0]} gathered {got[GROUP[0], :, 0].tolist()}, "
             f"want {QUICKSTART_GATHERED}")
    if not gathered_exactly(torch, out, x, GROUP):
        fail("quickstart's All-Gather: the members' inputs in group order at each member "
             "and zeros elsewhere, bit for bit, do not hold")
    if not np.array_equal(got.view(np.uint32), interp.view(np.uint32)):
        fail("quickstart's All-Gather differs from the numpy round interpreter")
    prog, _ = synthesize_program(topo, req)
    faulty = pccl_all_gather(x, topo, req, program=last_round_dropped(prog))
    if gathered_exactly(torch, faulty, x, GROUP):
        fail("quickstart's All-Gather check passes a planted fault (the last round dropped)")
    wrong = [d for d in GROUP if not torch.equal(faulty[d], out[d])]
    print(f"  quickstart's All-Gather on {n} stacked ranks on {dev}: NPU {GROUP[0]} gathered "
          f"{QUICKSTART_GATHERED}, every member the group's inputs in group order and the "
          f"{n - len(GROUP)} other NPUs zeros, bit for bit, and the numpy interpreter's bits; "
          f"planted fault (the last of {prog.num_rounds} rounds dropped): NPUs {wrong} "
          f"gather {[faulty[d, :, 0].tolist() for d in wrong]}, the check fails as it must")


def examples_phase(torch, dev) -> None:
    """The planner examples on the card's host and device: synthesize_pod's
    and quickstart's output, quickstart's All-Gather held bit for bit
    (``quickstart_gather_checks``), then the same plan carrying one
    ``GATHER_ARCH`` layer's bf16 weights split over the group's members,
    held bit for bit (and the layer reassembled at each member) with the
    last round dropped as the planted fault, timed beside the plain gather
    and the rounds' bytes over the card's memory rate."""
    import torch.nn.functional as F

    from repro_torch.bridge import named_leaves
    from repro_torch.comms import pccl_all_gather, synthesize_program
    from repro_torch.configs import get_config
    from repro_torch.core import CollectiveRequest
    from repro_torch.examples import quickstart, synthesize_pod
    from repro_torch.launch import trace
    from repro_torch.models import LM
    from repro_torch.topology import mesh2d

    t0 = time.perf_counter()
    phase("examples")
    synthesize_pod.main()
    print()
    quickstart.main([])
    quickstart_gather_checks(torch, dev)

    group = list(quickstart.GROUP)
    g = len(group)
    cfg = dataclasses.replace(get_config(GATHER_ARCH), num_layers=1)
    layer = torch.cat([leaf.reshape(-1).to(torch.bfloat16) for _, leaf in
                       named_leaves(LM(cfg, device=dev).init(0)["layers"])])
    E = -(-layer.numel() // g)
    topo = mesh2d(4, 4)
    req = CollectiveRequest("all_gather", group=quickstart.GROUP)
    n = len(topo.npus)
    prog, plan = synthesize_program(topo, req)
    chunk_bytes = E * 2
    buf_bytes = n * plan.buffer_slots * chunk_bytes
    out_bytes = n * g * chunk_bytes
    print(f"  one {GATHER_ARCH} layer: {layer.numel()} bf16 parameters, {E} a member "
          f"({chunk_bytes / 1e6:.1f} MB); {prog.num_rounds} rounds, {prog.num_sends} sends, "
          f"{plan.buffer_slots} slots a rank; reckoned: the buffer {n} x {plan.buffer_slots} "
          f"x {chunk_bytes / 1e6:.1f} MB = {buf_bytes / 1e9:.3f} GB, the output "
          f"[{n}, {g}, {E}] {out_bytes / 1e9:.3f} GB")
    gen = torch.Generator(device=dev).manual_seed(3)
    # the other NPUs hold noise, which must reach no output
    x = torch.randn((n, E), generator=gen, device=dev).to(torch.bfloat16)
    x[group] = F.pad(layer, (0, g * E - layer.numel())).view(g, E)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    out = pccl_all_gather(x, topo, req)
    torch.cuda.synchronize(dev)
    call_peak = torch.cuda.max_memory_allocated(dev) - held
    if not gathered_exactly(torch, out, x, group):
        fail(f"the {GATHER_ARCH} layer's All-Gather is not bit-exact")
    for m in group:
        if not torch.equal(out[m].reshape(-1)[:layer.numel()].view(torch.int16),
                           layer.view(torch.int16)):
            fail(f"NPU {m} did not reassemble the {GATHER_ARCH} layer")
    del out
    faulty = pccl_all_gather(x, topo, req, program=last_round_dropped(prog))
    if gathered_exactly(torch, faulty, x, group):
        fail(f"the {GATHER_ARCH} layer's All-Gather check passes a planted fault (the last "
             f"round dropped)")
    del faulty

    def plain():
        got = torch.zeros((n, g, E), dtype=x.dtype, device=dev)
        got[group] = x[group]
        return got

    times = time_turns(torch, {"pccl": (lambda: pccl_all_gather(x, topo, req), 3),
                               "plain": (plain, 3)})
    rounds_bytes = executor_bytes(plan, chunk_bytes)
    bound_ms = rounds_bytes / PEAK_BYTES * 1e3
    io_bytes = (g + n * g) * chunk_bytes  # the members' rows read, the output written
    # the call beside its rounds: zeros for the buffer, the input put in
    # (read, write), the output gathered (read, write) and masked (read, write)
    call_bytes = rounds_bytes + (n * plan.buffer_slots + 2 * n + 4 * n * g) * chunk_bytes
    traced = trace.traced(lambda: pccl_all_gather(x, topo, req), dev)
    print(f"  {GATHER_ARCH} layer All-Gather on {n} stacked ranks: bit-exact at every rank, "
          f"the layer reassembled at NPUs {group}; planted fault (the last round dropped) "
          f"fails the check; the call's peak {call_peak / 1e9:.3f} GB above its input "
          f"(reckoned {(buf_bytes + out_bytes) / 1e9:.3f} GB)")
    print(f"  {GATHER_ARCH} layer All-Gather: {times['pccl']:.3f} ms a call (median of 3 "
          f"rounds of 3, CUDA events); the plain gather {times['plain']:.3f} ms; bound "
          f"{bound_ms:.3f} ms by the rounds' bytes ({rounds_bytes / 1e9:.3f} GB at "
          f"{PEAK_BYTES / 1e12:.2f} TB/s; {times['pccl'] / bound_ms:.2f}x); the call "
          f"{call_bytes / 1e9:.3f} GB ({call_bytes / times['pccl'] / 1e9:.3f} TB/s of modelled "
          f"traffic); the function's input and output {io_bytes / 1e9:.3f} GB "
          f"({io_bytes / PEAK_BYTES * 1e3:.3f} ms)")
    trace.print_phase(f"  {GATHER_ARCH} layer All-Gather, one call traced", traced, 1, 6)
    print(f"examples: gather_ms={times['pccl']:.3f} plain_ms={times['plain']:.3f} "
          f"bound_ms={bound_ms:.3f} rounds_bytes={rounds_bytes} call_bytes={call_bytes} "
          f"buffer_bytes={buf_bytes} call_peak={call_peak} B launches={traced['launches']}; "
          f"{time.perf_counter() - t0:.1f} s")
    del x, layer
    torch.cuda.empty_cache()


def stepped_agree(got: dict, want: dict, S: int, tol: float) -> tuple[float, bool, int]:
    """Two ``serve_stepped`` runs of S prompt tokens: their logits allclose
    (rtol = atol = ``tol``) at every step up to the first generated token
    that differs, and a token may differ only where ``want``'s top two
    logits lie within ``2 * tol * (1 + |top|)`` (a near-tie; the two then
    decode other sequences). Returns (the largest abs error over those
    steps, whether both hold, the tokens a row compared)."""
    got_t, want_t = got["tokens"].cpu(), want["tokens"].cpu()
    differ = (got_t != want_t).any(0).nonzero()
    first = int(differ[0]) if len(differ) else want_t.shape[1]
    steps = S + first  # logits 0 .. S - 1 + first give tokens 0 .. first
    want_l = want["logits"][:, :steps].cpu().float()
    err, ok = compare(got["logits"][:, :steps].cpu(), want_l, tol)
    if first < want_t.shape[1]:
        top = want_l[:, S - 1 + first].topk(2, -1).values
        rows = got_t[:, first] != want_t[:, first]
        near = (top[:, 0] - top[:, 1]) <= 2 * tol * (1 + top[:, 0].abs())
        ok = ok and bool(near[rows].all())
    return err, ok, first


def shifted_prompt_logits(lm, params, prompts):
    """A planted fault: the prompt stepped at positions 1 .. S instead of
    0 .. S - 1, slot 0 of the cache left empty; the logits of every step
    [B, S, vocab]."""
    import torch

    B, S = prompts.shape
    with torch.inference_mode():
        cache = lm.decode_init(B, S + 1, dtype=torch.float32)
        return torch.stack([lm.decode_step(params, cache, prompts[:, t], t + 1)[0]
                            for t in range(S)], dim=1)


def stepped_checks(cfg, lm, params, prompts, new_tokens: int, tol: float, want: dict,
                   fault: bool = False) -> dict:
    """serve_batch's ``serve_stepped`` of ``prompts`` [B, S] and
    ``new_tokens``, with no flash launch, against the one-pass prefill:
    the last prompt step's logits against ``LM.prefill`` and every prompt
    step's against ``LM.forward_logits``, both through the flash kernel
    (each counter of ``want`` counts its launches in each), by rel-L2 within
    ``tol``. With ``fault``, the prompt stepped at positions shifted by one
    must miss every prompt step's logits by more than ``tol``. Prints the
    stepped prefill's ms beside the one-pass prefill's (median of 3, host
    clock and a synchronise), decode ms a step and tokens/s. Returns the
    numbers."""
    import torch

    from repro_torch.examples.serve_batch import serve_stepped
    from repro_torch.launch.serve import synchronize

    dev = lm.device
    B, S = prompts.shape
    serve_stepped(lm, params, prompts[:, :4], 2)  # warm-up: library start-up
    for counter in want:
        counter.launches = 0
    out = serve_stepped(lm, params, prompts, new_tokens)
    stepped = {c.__name__: c.launches for c in want if c.launches}
    if stepped:
        fail(f"{cfg.name} {cfg.dtype}: the stepped serve launched flash kernels {stepped}")
    toks = out["tokens"]
    if toks.shape != (B, new_tokens) or not ((toks >= 0) & (toks < cfg.vocab_size)).all() \
            or not torch.isfinite(out["logits"]).all():
        fail(f"{cfg.name} {cfg.dtype}: bad stepped serve, tokens {tuple(toks.shape)}")
    def counted(run):
        for counter in want:
            counter.launches = 0
        got = run()
        synchronize(dev)
        launches = {c.__name__: c.launches for c in want}
        if launches != {c.__name__: n for c, n in want.items()}:
            fail(f"{cfg.name} {cfg.dtype}: flash launches {launches} in one pass, want "
                 f"{ {c.__name__: n for c, n in want.items()} }")
        return got

    with torch.inference_mode():
        one_pass = counted(lambda: lm.prefill(params, prompts)[0])
        every = counted(lambda: lm.forward_logits(params, prompts))
        spans = []
        for _ in range(3):
            synchronize(dev)
            t0 = time.perf_counter()
            lm.prefill(params, prompts)
            synchronize(dev)
            spans.append(time.perf_counter() - t0)
    e_last = rel_l2(out["logits"][:, S - 1], one_pass)
    e_all = rel_l2(out["logits"][:, :S], every)
    print(f"  {cfg.dtype}: stepped prefill vs LM.prefill at the last of {S} positions: "
          f"rel_l2={e_last:.3g}; every prompt step vs forward_logits: rel_l2={e_all:.3g} "
          f"(tol rel_l2 {tol}); flash launches a pass "
          f"{ {c.__name__: n for c, n in want.items() if n} }, none stepped")
    if not (e_last <= tol and e_all <= tol):
        fail(f"{cfg.name} {cfg.dtype}: the stepped prefill disagrees with the one-pass prefill")
    if fault:
        shifted = shifted_prompt_logits(lm, params, prompts)
        f_all, f_last = rel_l2(shifted, every), rel_l2(shifted[:, -1], one_pass)
        print(f"  {cfg.dtype}: planted fault (the prompt stepped at positions 1..{S}): every "
              f"prompt step rel_l2={f_all:.3g}, the last {f_last:.3g} (must exceed {tol})")
        if not f_all > tol:
            fail(f"{cfg.name} {cfg.dtype}: the stepped prefill check passes a planted fault "
                 f"(positions shifted by one)")
        del shifted
    res = {"stepped_prefill_ms": out["prefill_s"] * 1e3,
           "one_pass_prefill_ms": statistics.median(spans) * 1e3,
           "decode_ms": out["decode_s"] * 1e3 / max(new_tokens - 1, 1),
           "tok_s": B * (new_tokens - 1) / out["decode_s"] if out["decode_s"] > 0 else 0.0,
           "rel_last": e_last, "rel_all": e_all}
    print(f"serve_batch {cfg.name} {cfg.dtype} layers={cfg.num_layers} {B}x{S}: "
          f"stepped_prefill_ms={res['stepped_prefill_ms']:.3f} "
          f"one_pass_prefill_ms={res['one_pass_prefill_ms']:.3f} "
          f"decode_ms_per_step={res['decode_ms']:.3f} decode_tok_per_s={res['tok_s']:.1f} "
          f"({new_tokens - 1} steps)")
    return res


def serve_batch_phase(torch, dev, fa) -> None:
    """serve_batch at its defaults on the card (reduced llama3.2-1b, f32),
    every step's logits held to a CPU run of ``serve_stepped`` on the same
    params; then full-width llama3.2-1b stepped in bf16 (the wgmma route's
    16 launches a one-pass prefill) and f32 (the mma route's), each against
    the one-pass prefill (``stepped_checks``), the shifted positions planted
    in bf16."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_batch
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import LM

    t0 = time.perf_counter()
    phase("serve_batch")
    serve_batch.main([])
    B, S, new = SERVE_BATCH_DEFAULTS
    small = get_config("llama3.2-1b").reduced(dtype="float32")
    cpu_lm, gpu_lm = LM(small, device="cpu"), LM(small, device=dev)
    params = cpu_lm.init(serve_batch.WEIGHT_SEED)
    prompts = torch.from_numpy(make_prompts(B, S, small.vocab_size, serve_batch.PROMPT_SEED))
    want = serve_batch.serve_stepped(cpu_lm, params, prompts, new)
    got = serve_batch.serve_stepped(gpu_lm, to_device(params, dev), prompts.to(dev), new)
    err, ok, first = stepped_agree(got, want, S, REDUCED_F32_TOL)
    print(f"  reduced f32 at the defaults {SERVE_BATCH_DEFAULTS}, card vs CPU: every step's "
          f"logits max_abs_err={err:.3g} (rtol = atol = {REDUCED_F32_TOL}), tokens equal over "
          f"{first} of {new} a row")
    if not ok:
        fail("serve_batch's stepped serve on the card disagrees with the CPU")
    cfg = get_config("llama3.2-1b")
    L = cfg.num_layers
    for c, tol, want in ((cfg, LOGITS_REL_TOL, flash_want(fa, wgmma=L)),
                         (dataclasses.replace(cfg, dtype="float32"), LLAMA_F32_REL_TOL,
                          flash_want(fa, mma=L))):
        lm, params = init_model(c)
        prompts = torch.from_numpy(make_prompts(
            SERVE_BATCH, STEPPED_PROMPT, c.vocab_size, serve_batch.PROMPT_SEED)).to(dev)
        stepped_checks(c, lm, params, prompts, STEPPED_NEW, tol, want,
                       fault=c.dtype == "bfloat16")
        del lm, params
        torch.cuda.empty_cache()
    print(f"serve_batch: phase took {time.perf_counter() - t0:.1f} s")


def one_rank_nccl_group(torch):
    """A one-rank NCCL process group on card 0 (a file rendezvous in a
    temporary directory, no port); returns the function that ends it."""
    import shutil
    import tempfile

    import torch.distributed as dist

    where = tempfile.mkdtemp()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{where}/rendezvous", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))

    def end():
        dist.destroy_process_group()
        shutil.rmtree(where, ignore_errors=True)
    return end


def full(x):
    """A DTensor's whole value; a plain tensor as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def served_logits(torch, lm, params, prompts, new: int,
                  stub: dict | None = None) -> tuple[list, float, float]:
    """Prefill ``prompts`` (over the encdec family's ``stub`` frames) and
    ``new`` greedy decode steps: (the prefill's and each step's f32 logits,
    prefill ms, decode ms a step)."""
    from repro_torch.launch.serve import synchronize

    dev = lm.device
    S = prompts.shape[1]
    with torch.inference_mode():
        synchronize(dev)
        t0 = time.perf_counter()
        logits, cache = lm.prefill(params, prompts, max_seq=S + new, **(stub or {}))
        out = [full(logits)]
        synchronize(dev)
        t1 = time.perf_counter()
        for i in range(new):
            logits, cache = lm.decode_step(params, cache, out[-1].argmax(-1), S + i)
            out.append(full(logits))
        synchronize(dev)
        t2 = time.perf_counter()
    return out, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / new


def train_grads(torch, lm, params, batch: dict) -> tuple:
    """One loss and its gradient of every leaf: (loss, {path: grad}, ms)."""
    from repro_torch.bridge import named_leaves
    from repro_torch.launch.serve import synchronize

    def leaf(t):
        if isinstance(t, dict):
            return {k: leaf(v) for k, v in t.items()}
        return t.detach().requires_grad_(True)

    params = leaf(params)
    synchronize(lm.device)
    t0 = time.perf_counter()
    loss, _ = lm.loss(params, batch)
    loss.backward()
    synchronize(lm.device)
    ms = (time.perf_counter() - t0) * 1e3
    return loss.detach(), {path: full(p.grad) for path, p in named_leaves(params)}, ms


def policy_path_checks(torch, dev, fa, smi_line: str) -> dict:
    """(a): ``LM(policy=)`` at data = 1 x model = 1 on a one-rank NCCL group,
    full-width llama3.2-1b in bf16: the params are DTensors, the flash
    kernels take their local shards; prefill of SERVE_BATCH x SERVE_PROMPT,
    SERVE_NEW greedy decode steps and one training step (f32 master
    weights) each bit for bit the same as without the policy, the flash
    launches of the policy's runs counted exactly. Returns the times."""
    from torch.distributed.tensor import DTensor

    from repro_torch.bridge import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import _batch_for_step
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.sharding import ShardingPolicy
    from repro_torch.models import LM

    end = one_rank_nccl_group(torch)
    try:
        cfg = get_config(POLICY_ARCH)
        pol = ShardingPolicy(make_test_mesh(data=1, model=1), cfg)
        plain, lm = LM(cfg, device=dev), LM(cfg, device=dev, policy=pol)
        params = plain.init(0)
        placed = pol.param_shardings(params)
        leaves = named_leaves(placed)
        if not all(isinstance(x, DTensor) for _, x in leaves):
            fail("the policy's params are not all DTensors")
        print(f"  {cfg.name} {cfg.dtype}: {len(leaves)} param leaves placed as DTensors on a "
              f"{dict(pol.mesh.axis_sizes)} NCCL mesh, e.g. layers.attn.wq "
              f"{placed['layers']['attn']['wq'].placements}")
        prompts = torch.from_numpy(make_prompts(SERVE_BATCH, SERVE_PROMPT,
                                                cfg.vocab_size, 0)).to(dev)
        L = cfg.num_layers
        served_logits(torch, plain, params, prompts, 2)  # warm-up
        served_logits(torch, lm, placed, prompts, 2)
        want, plain_prefill, plain_decode = served_logits(torch, plain, params, prompts,
                                                          SERVE_NEW)
        counters = flash_want(fa, wgmma=L)
        for c in counters:
            c.launches = 0
        got, pol_prefill, pol_decode = served_logits(torch, lm, placed, prompts, SERVE_NEW)
        counted = {c: c.launches for c in counters}
        if counted != counters:
            fail(f"flash launches of the policy's serve {({c.__name__: n for c, n in counted.items()})}"
                 f", want {({c.__name__: n for c, n in counters.items()})}")
        same = [torch.equal(a, b) for a, b in zip(got, want)]
        print(f"  serve {SERVE_BATCH}x{SERVE_PROMPT} + {SERVE_NEW} steps: prefill logits "
              f"bit-equal {same[0]}, decode steps bit-equal {sum(same[1:])} of {SERVE_NEW}; "
              f"flash_attention_wgmma launches {counted[fa.flash_attention_wgmma]} (want {L})")
        if not all(same):
            fail("the policy's serve is not bit-equal to the serve without it")
        del got, want, placed, params
        torch.cuda.empty_cache()

        params = plain.init(0, param_dtype=torch.float32)
        placed = pol.param_shardings(params)
        raw = _batch_for_step(0, 0, SERVE_BATCH, SERVE_PROMPT, cfg.vocab_size)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        train_grads(torch, plain, params, batch)  # warm-up
        want_loss, want_grads, plain_step = train_grads(torch, plain, params, batch)
        train_grads(torch, lm, placed, batch)
        fwd_bwd = {fa.flash_attention_wgmma: L, **bwd_counters(fa, L, cfg.head_dim, cfg.dtype)}
        for c in fwd_bwd:
            c.launches = 0
        got_loss, got_grads, pol_step = train_grads(torch, lm, placed, batch)
        counted = {c: c.launches for c in fwd_bwd}
        same = [torch.equal(got_grads[k], w) for k, w in want_grads.items()]
        print(f"  train step {SERVE_BATCH}x{SERVE_PROMPT} (f32 master weights, bf16 compute): "
              f"loss {float(got_loss):.6f} bit-equal {torch.equal(got_loss, want_loss)}, "
              f"gradient leaves bit-equal {sum(same)} of {len(same)}; launches "
              f"{({c.__name__: n for c, n in counted.items()})}")
        if counted != fwd_bwd:
            fail(f"flash launches of the policy's train step "
                 f"{({c.__name__: n for c, n in counted.items()})}, want "
                 f"{({c.__name__: n for c, n in fwd_bwd.items()})}")
        if not (torch.equal(got_loss, want_loss) and all(same)):
            fail("the policy's training step is not bit-equal to the step without it")
        times = dict(prefill_ms=(plain_prefill, pol_prefill),
                     decode_ms=(plain_decode, pol_decode), step_ms=(plain_step, pol_step))
        print(f"  host cost of DTensor ({smi_line}), without / with the policy: " + ", ".join(
            f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in times.items()))
        del placed, params, want_grads, got_grads
    finally:
        end()
    torch.cuda.empty_cache()
    return times


def padded_head_checks(torch, dev, fa) -> dict:
    """(b): each of ``PAD_CASES`` padded by ``pad_heads`` at model =
    ``PAD_TP`` and carried by ``pad_head_params``: prefill and
    ``PAD_DECODE`` steps of the padded model against the unpadded one, the
    padded prefill's flash launches counted, in the moe family the first
    layer's routes compared. Three runs a model (``pad_runs``): bf16 and
    f32 at the case's depth, and f32 at ``PAD_F32_LAYERS``, where the
    1e-5 limit holds; there the reference's layout (pad heads appended, wo
    rows zero) must fail it. At the case's depth in f32 the unpadded model
    is also served at half the batch, its rows held to its own batch-4
    rows: the floor that the card's f32 products set. Returns {(arch,
    dtype, layers): worst rel-L2}."""
    from repro_torch.bridge import pad_head_params
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import stub_inputs
    from repro_torch.launch.serve import make_prompts, synchronize
    from repro_torch.launch.sharding import pad_heads
    from repro_torch.models import LM

    worst = {}
    for arch, layers in PAD_CASES:
        for dt, L, tol in pad_runs(arch, layers or get_config(arch).num_layers):
            cfg = dataclasses.replace(get_config(arch), dtype=dt, num_layers=L)
            padded = pad_heads(cfg, PAD_TP)
            lm = LM(cfg, device=dev)
            plm = LM(padded, device=dev, ep_degree=PAD_TP if cfg.is_moe else 1)
            params = lm.init(0)
            experts = plm.e_pad if cfg.is_moe else None
            carried = pad_head_params(params, cfg, padded, experts=experts)
            prompts = torch.from_numpy(make_prompts(SERVE_BATCH, SERVE_PROMPT,
                                                    cfg.vocab_size, 0)).to(dev)
            stub = to_device({k: torch.from_numpy(x) for k, x in
                              stub_inputs(cfg, SERVE_BATCH, 0).items()}, dev)
            start = (stub["patches"].shape[1] if stub else 0) + SERVE_PROMPT
            want_launch = flash_want(fa, **{"wgmma" if dt == "bfloat16" else "mma": L})
            exact = tol == PAD_F32_REL_TOL
            label = f"{arch} layers={L} {dt}"
            with torch.inference_mode():
                if cfg.is_moe:
                    lm.routes, plm.routes = [], []
                for c in want_launch:
                    c.launches = 0
                pl, pc = plm.prefill(carried, prompts, max_seq=start + PAD_DECODE, **stub)
                synchronize(dev)
                counted = {c: c.launches for c in want_launch}
                if counted != want_launch:
                    fail(f"padded {label}: flash launches "
                         f"{({c.__name__: n for c, n in counted.items()})}")
                ul, uc = lm.prefill(params, prompts, max_seq=start + PAD_DECODE, **stub)
                unpadded = ul
                errs = [rel_l2(pl, ul)]
                flips = None
                if cfg.is_moe:
                    per_layer = lm.routes[0][0].numel()
                    flips = routes_differ(plm.routes, lm.routes)[0]
                    lm.routes = plm.routes = None
                tok = ul.argmax(-1)
                for i in range(PAD_DECODE):
                    ul, uc = lm.decode_step(params, uc, tok, start + i)
                    pl, pc = plm.decode_step(carried, pc, tok, start + i)
                    errs.append(rel_l2(pl, ul))
                    tok = ul.argmax(-1)
                del pc, uc
                first = flips[0] / per_layer if flips is not None else 0.0
                print(f"  {label}: {cfg.num_heads} -> {padded.num_heads} heads (GQA group "
                      f"{cfg.num_heads // cfg.num_kv_heads} -> "
                      f"{padded.num_heads // padded.num_kv_heads})"
                      f"{f', experts {cfg.num_experts} -> {experts}' if experts else ''}: "
                      f"padded vs unpadded rel_l2 prefill {errs[0]:.3g}, {PAD_DECODE} decode "
                      f"steps max {max(errs[1:]):.3g} (tol {tol}); flash launches a padded "
                      f"prefill {counted[fa.flash_attention]}"
                      + (f"; pairs routed to another expert, by layer {flips} (the first "
                         f"layer's share {first:.3g}, tol {MOE_FIRST_LAYER_ROUTES})"
                         if flips is not None else ""))
                if not max(errs) <= tol or not first <= MOE_FIRST_LAYER_ROUTES:
                    fail(f"the padded {label} disagrees with the unpadded model")
                worst[(arch, dt, L)] = max(errs)
                if dt == "float32" and not exact:  # the floor: the same model, other shapes
                    half = SERVE_BATCH // 2
                    own = lm.prefill(params, prompts[:half], **rows(stub, half))[0]
                    print(f"  {label}: the unpadded model's prefill at batch {half} against "
                          f"its own batch-{SERVE_BATCH} rows: rel_l2 "
                          f"{rel_l2(own, unpadded[:half]):.3g} (printed, no limit)")
                if exact:
                    appended = pad_head_params(params, cfg, padded, experts=experts,
                                               positions=list(range(cfg.num_heads)))
                    e_fault = rel_l2(plm.prefill(appended, prompts, **stub)[0],
                                     lm.prefill(params, prompts, **stub)[0])
                    print(f"  {label}: planted fault (the reference's layout: pad heads "
                          f"appended, wo rows zero) vs unpadded: rel_l2={e_fault:.3g} (must "
                          f"exceed {tol})")
                    if not e_fault > tol:
                        fail(f"the padded {label} check passes the appended layout")
                    del appended
            del lm, plm, params, carried, pl, ul, unpadded
            torch.cuda.empty_cache()
    return worst


def pad_runs(arch: str, layers: int) -> list:
    """(dtype, layers, rel-L2 limit) of each padded-model run of ``arch``."""
    return [("bfloat16", layers, PAD_BF16_REL_TOL[arch]),
            ("float32", layers, LLAMA_F32_REL_TOL),
            ("float32", PAD_F32_LAYERS[arch], PAD_F32_REL_TOL)]


def padded_wgmma_times(torch, dev, fa, smi_line: str) -> dict:
    """The wgmma route at the padded models' attention shapes (GQA groups 4
    and 8), bf16 causal, against its plain version, timed beside SDPA and
    its bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch.sharding import pad_heads

    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for arch, _ in PAD_CASES:
        cfg = pad_heads(get_config(arch), PAD_TP)
        S = SERVE_PROMPT + (LLAVA_PATCHES if cfg.family == "vlm" else 0)
        shape = (SERVE_BATCH, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        (q, k, v), (qt, kt, vt) = attention_inputs(torch, gen, dev, shape, "bfloat16")
        before = fa.flash_attention_wgmma.launches
        got = ops.flash_attention(q, k, v, causal=True)
        if fa.flash_attention_wgmma.launches != before + 1:
            fail(f"the padded {arch} shape {shape} did not go to the wgmma route")
        n = 1 if cfg.family == "vlm" else SERVE_BATCH  # the plain f32 scores of a row
        err, ok = compare(got[:n], flash_attention_ref(q[:n], k[:n], v[:n], causal=True),
                          BF16_TOL)
        if not ok:
            fail(f"the wgmma route disagrees with its plain version at {shape}")
        pair = {"kernel": lambda: ops.flash_attention(q, k, v, causal=True),
                "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)}
        ms = time_pair(torch, pair, 20)
        bound = attention_bound(q, k, v, True, 0)
        print(f"  wgmma route at padded {arch} {shape} bfloat16 causal ({smi_line}): kernel "
              f"{ms['kernel']:.4f} ms, sdpa {ms['sdpa']:.4f} ms "
              f"({ms['kernel'] / ms['sdpa']:.2f}x); max_abs_err {err:.3g} on {n} row(s); "
              f"bound {bound[0] * 1e3:.2f} us by {bound[1]} ({bound_terms(bound[4])}); "
              f"{ms['kernel'] / bound[0]:.2f}x its bound")
        out[arch] = dict(ms, shape=shape, err=err, bound=bound[0])
        del q, k, v, qt, kt, vt, pair
    torch.cuda.empty_cache()
    return out


def policy_family_checks(torch, dev, fa, ssd, smi_line: str) -> dict:
    """(c): ``LM(policy=)`` at data = 1 x model = 1 on a one-rank NCCL group
    for ``POLICY_FAMILY_CASES`` in bf16: a prefill of SERVE_BATCH x
    SERVE_PROMPT (whisper: x WHISPER_PROMPT over SERVE_BATCH x 1500 stub
    frames), POLICY_FAMILY_DECODE greedy decode steps and one training step
    (f32 master weights; whisper at its WHISPER_TEXT positions), each bit for
    bit the same as without the policy, the SSD and flash launches of the
    policy's runs counted exactly. Returns {arch: times}."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import _batch_for_step, stub_inputs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.sharding import ShardingPolicy
    from repro_torch.models import LM

    out = {}
    end = one_rank_nccl_group(torch)
    try:
        for arch, layers in POLICY_FAMILY_CASES:
            t0 = time.perf_counter()
            full = get_config(arch)
            cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
            pol = ShardingPolicy(make_test_mesh(data=1, model=1), cfg)
            plain, lm = LM(cfg, device=dev), LM(cfg, device=dev, policy=pol)
            L = cfg.num_layers
            ssd_blocks = L if cfg.family in ("ssm", "hybrid") else 0
            attn_calls = {"hybrid": L // max(cfg.hybrid_attn_period, 1),
                          "encdec": cfg.encoder_layers + 2 * L}.get(cfg.family, 0)
            route = fa.route(torch.bfloat16, cfg.head_dim)
            serve_want = {ssd.ssd_scan: ssd_blocks, **flash_want(fa, **{route: attn_calls})}
            S = WHISPER_PROMPT if cfg.family == "encdec" else SERVE_PROMPT
            stub = to_device({k: torch.from_numpy(x) for k, x in
                              stub_inputs(cfg, SERVE_BATCH, 0).items()}, dev)
            label = f"{arch} layers={L}"

            params = plain.init(0)
            placed = pol.param_shardings(params)
            prompts = torch.from_numpy(make_prompts(SERVE_BATCH, S, cfg.vocab_size, 0)).to(dev)
            served_logits(torch, plain, params, prompts, 2, stub)  # warm-up
            served_logits(torch, lm, placed, prompts, 2, stub)
            want, plain_prefill, plain_decode = served_logits(
                torch, plain, params, prompts, POLICY_FAMILY_DECODE, stub)
            for c in serve_want:
                c.launches = 0
            got, pol_prefill, pol_decode = served_logits(
                torch, lm, placed, prompts, POLICY_FAMILY_DECODE, stub)
            counted = {c: c.launches for c in serve_want}
            names = {c.__name__: n for c, n in counted.items() if n or serve_want[c]}
            if counted != serve_want:
                fail(f"{label}: launches of the policy's serve {names}, want "
                     f"{({c.__name__: n for c, n in serve_want.items() if n})}")
            same = [torch.equal(a, b) for a, b in zip(got, want)]
            print(f"  (c) {label} {cfg.dtype}, serve {SERVE_BATCH}x{S} + "
                  f"{POLICY_FAMILY_DECODE} steps: prefill logits bit-equal {same[0]}, decode "
                  f"steps bit-equal {sum(same[1:])} of {POLICY_FAMILY_DECODE}; launches {names}")
            if not all(same):
                fail(f"the policy's {label} serve is not bit-equal to the serve without it")
            del got, want, placed, params
            torch.cuda.empty_cache()

            params = plain.init(0, param_dtype=torch.float32)
            placed = pol.param_shardings(params)
            S_train = WHISPER_TEXT if cfg.family == "encdec" else SERVE_PROMPT
            raw = _batch_for_step(0, 0, SERVE_BATCH, S_train, cfg.vocab_size)
            batch = {**{k: torch.from_numpy(v).to(dev, torch.int64) for k, v in raw.items()},
                     **stub}
            train_grads(torch, plain, params, batch)  # warm-up
            want_loss, want_grads, plain_step = train_grads(torch, plain, params, batch)
            train_grads(torch, lm, placed, batch)
            train_want = {ssd.ssd_scan: ssd_blocks, ssd.ssd_scan_bwd: ssd_blocks,
                          fa.flash_attention: attn_calls,
                          **bwd_counters(fa, attn_calls, cfg.head_dim)}
            for c in train_want:
                c.launches = 0
            got_loss, got_grads, pol_step = train_grads(torch, lm, placed, batch)
            counted = {c: c.launches for c in train_want}
            names = {c.__name__: n for c, n in counted.items()}
            if counted != train_want:
                fail(f"{label}: launches of the policy's training step {names}, want "
                     f"{({c.__name__: n for c, n in train_want.items()})}")
            same = [torch.equal(got_grads[k], w) for k, w in want_grads.items()]
            print(f"  (c) {label}, train step {SERVE_BATCH}x{S_train} (f32 master weights, bf16 "
                  f"compute): loss {float(got_loss):.6f} bit-equal "
                  f"{torch.equal(got_loss, want_loss)}, gradient leaves bit-equal {sum(same)} "
                  f"of {len(same)}; launches {names}")
            if not (torch.equal(got_loss, want_loss) and all(same)):
                fail(f"the policy's {label} training step is not bit-equal to the step "
                     f"without it")
            times = dict(prefill_ms=(plain_prefill, pol_prefill),
                         decode_ms=(plain_decode, pol_decode), step_ms=(plain_step, pol_step))
            print(f"  (c) {label}, host cost of DTensor ({smi_line}), without / with the "
                  f"policy: " + ", ".join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in times.items())
                  + f"; {time.perf_counter() - t0:.1f} s")
            out[arch] = times
            del placed, params, want_grads, got_grads, plain, lm
            torch.cuda.empty_cache()
    finally:
        end()
    return out


def tp_ssd_times(torch, dev, gen, ops, ssd, smi_line: str) -> dict:
    """(d), the SSD scan and its backward at one rank's share of the heads
    at ``TP_DEGREES``: the last rank's heads of ``TP_SSD_SHAPES`` (slow
    decay), held against the plain versions (the token-by-token recurrence;
    autograd through the chunked scan), compared bit for bit with the same
    heads of the call over every head (y, the state, dx, ddt, dA: dB and
    dC are sums over heads), timed beside the plain versions and the
    bounds. Returns {"ssd_scan": [...], "ssd_scan_bwd": [...]} for the
    kernels line."""
    from repro_torch.kernels.ref import ssd_scan_bwd_ref, ssd_scan_ref

    out = {"ssd_scan": [], "ssd_scan_bwd": []}
    for arch, (B, S, H, P, N, chunk) in TP_SSD_SHAPES.items():
        xh, dt, A, Bm, Cm = ssd_inputs(torch, gen, dev, B, S, H, P, N, slow=True)
        dy = torch.randn(xh.shape, generator=gen, device=dev)
        y_all, state_all = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk, return_state=True)
        grads_all = ops.ssd_scan_bwd(xh, dt, A, Bm, Cm, dy, chunk=chunk)
        for tp in TP_DEGREES:
            h = slice(H - H // tp, H)  # the last rank's heads
            r = (xh[:, :, h].contiguous(), dt[:, :, h].contiguous(), A[h].contiguous(), Bm, Cm)
            dyr = dy[:, :, h].contiguous()
            shape = (B, S, H // tp, P, N, chunk)
            y, state = ops.ssd_scan(*r, chunk=chunk, return_state=True)
            want_y, want_state = ssd_scan_ref(*r, return_state=True)
            checked = [compare(y, want_y, SSD_TOL), compare(state, want_state, SSD_TOL)]
            grads = ops.ssd_scan_bwd(*r, dyr, chunk=chunk)
            checked_bwd = [compare_scaled(g, w, SSD_BWD_TOL) for g, w in
                           zip(grads, ssd_scan_bwd_ref(*r, dyr, chunk=chunk))]
            if not all(c[1] for c in checked + checked_bwd):
                fail(f"the SSD scan or its backward disagrees with its plain version at "
                     f"{arch}'s rank shape {shape}")
            same = torch.equal(y, y_all[:, :, h]) and torch.equal(state, state_all[:, h])
            same_bwd = all(torch.equal(a, b) for a, b in zip(
                grads[:3], (grads_all[0][:, :, h], grads_all[1][:, :, h], grads_all[2][h])))
            del y, state, want_y, want_state, grads
            times = time_turns(torch, {
                "kernel": (lambda: ops.ssd_scan(*r, chunk=chunk, return_state=True), 10),
                "plain": (lambda: ssd_scan_ref(*r, return_state=True), 1),
                "bwd": (lambda: ops.ssd_scan_bwd(*r, dyr, chunk=chunk), 10),
                "plain_bwd": (lambda: ssd_scan_bwd_ref(*r, dyr, chunk=chunk), 2)})
            groups = ssd.bwd_groups(dev, *shape)
            for what, bound, kernel, plain, err, bit in (
                    ("ssd_scan", ssd_bound(r[0], Bm, chunk), "kernel", "plain",
                     max(c[0] for c in checked), same),
                    ("ssd_scan_bwd", ssd_bwd_bound(r[0], Bm, chunk), "bwd", "plain_bwd",
                     max(c[0] for c in checked_bwd), same_bwd)):
                print(f"  (d) {what} at {arch} model={tp}, {shape} f32 slow decay ({smi_line}): "
                      f"kernel {times[kernel]:.4f} ms, plain {times[plain]:.4f} ms; bound "
                      f"{bound[0] * 1e3:.2f} us by {bound[1]} ({bound_terms(bound[4])}); "
                      f"{times[kernel] / bound[0]:.2f}x its bound; max_abs_err {err:.3g}; "
                      f"bit-equal to the same heads of the {H}-head call: {bit}"
                      + (f"; heads a block (rev, chunk/dbc) {groups[:2]}"
                         if what == "ssd_scan_bwd" else ""))
                out[what].append(dict(case=f"{arch} model={tp}", shape=list(shape),
                                      ms=times[kernel], plain_ms=times[plain], bound_ms=bound[0],
                                      bound_by=bound[1], library_ms=None, max_abs_err=err,
                                      bit_equal_to_full=bit))
            del r, dyr
        del xh, dt, A, Bm, Cm, dy, y_all, state_all, grads_all
        torch.cuda.empty_cache()
    return out


def tp_flash_times(torch, dev, gen, fa, ops, smi_line: str) -> dict:
    """(d), the flash forward and backward (both on their wgmma routes) in
    bf16 at one rank's share of whisper-medium's 16 heads at ``TP_DEGREES``,
    at each of ``TP_FLASH_SHAPES``: the last rank's heads, held against the
    plain versions, compared bit for bit with the same heads of the 16-head
    call, timed beside the plain versions, the backward's mma route, SDPA's
    forward and backward and the bounds. Returns {"flash_attention_wgmma":
    [...], "flash_attention_bwd": [...]} for the kernels line."""
    from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"flash_attention_wgmma": [], "flash_attention_bwd": []}
    for name in TP_FLASH_SHAPES:
        B, S, T, H, KV, hd, causal = ENCDEC_VLM_SHAPES[name]
        (q, k, v), _ = attention_inputs(torch, gen, dev, (B, S, H, KV, hd), "bfloat16", T)
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        o_all = ops.flash_attention(q, k, v, causal=causal)
        grads_all = ops.flash_attention_bwd(q, k, v, o_all, do, causal=causal)
        for tp in TP_DEGREES:
            h = slice(H - H // tp, H)
            qr, kr, vr, dor = (x[:, :, h].contiguous() for x in (q, k, v, do))
            shape = (B, S, T, H // tp, KV // tp, hd)
            before = fa.flash_attention_wgmma.launches
            o = ops.flash_attention(qr, kr, vr, causal=causal)
            if fa.flash_attention_wgmma.launches != before + 1:
                fail(f"{name} at model={tp} {shape} did not go to the wgmma route")
            before = fa.flash_attention_bwd_wgmma.launches
            grads = ops.flash_attention_bwd(qr, kr, vr, o, dor, causal=causal)
            if fa.flash_attention_bwd_wgmma.launches != before + 1:
                fail(f"{name}'s backward at model={tp} {shape} did not go to the wgmma route")
            err, ok = compare(o, flash_attention_ref(qr, kr, vr, causal=causal), BF16_TOL)
            checked = [compare(g, w, BF16_TOL) for g, w in zip(
                grads, flash_attention_bwd_ref(qr, kr, vr, o, dor, causal=causal))]
            if not (ok and all(c[1] for c in checked)):
                fail(f"the flash forward or backward disagrees with its plain version at "
                     f"{name}'s rank shape {shape}")
            same = torch.equal(o, o_all[:, :, h])
            same_bwd = all(torch.equal(g, w[:, :, h]) for g, w in zip(grads, grads_all))
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                          for x in (qr, kr, vr))
            ot = sdpa(qt, kt, vt, is_causal=causal)
            dot = dor.transpose(1, 2).contiguous()
            times = time_turns(torch, {
                "kernel": (lambda: ops.flash_attention(qr, kr, vr, causal=causal), 20),
                "plain": (lambda: flash_attention_ref(qr, kr, vr, causal=causal), 3),
                "sdpa": (lambda: sdpa(qt.detach(), kt.detach(), vt.detach(),
                                      is_causal=causal), 20),
                "bwd": (lambda: ops.flash_attention_bwd(qr, kr, vr, o, dor, causal=causal), 10),
                "bwd_mma": (lambda: fa.flash_attention_bwd_mma(qr, kr, vr, o, dor,
                                                               causal=causal), 10),
                "plain_bwd": (lambda: flash_attention_bwd_ref(qr, kr, vr, o, dor,
                                                              causal=causal), 2),
                "sdpa_bwd": (lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                         retain_graph=True), 10)})
            for what, bound, kernel, plain, lib, e, bit in (
                    ("flash_attention_wgmma", attention_bound(qr, kr, vr, causal, 0), "kernel",
                     "plain", "sdpa", err, same),
                    ("flash_attention_bwd", attention_bwd_bound(qr, kr, causal, 0), "bwd",
                     "plain_bwd", "sdpa_bwd", max(c[0] for c in checked), same_bwd)):
                mma = (f", mma route {times['bwd_mma']:.4f} ms"
                       if what == "flash_attention_bwd" else "")
                print(f"  (d) {what} at {name} model={tp}, {shape} bfloat16 "
                      f"{'causal' if causal else 'non-causal'} ({smi_line}): kernel "
                      f"{times[kernel]:.4f} ms{mma}, plain {times[plain]:.4f} ms, sdpa "
                      f"{times[lib]:.4f} ms; bound {bound[0] * 1e3:.2f} us by {bound[1]} "
                      f"({bound_terms(bound[4])}); {times[kernel] / bound[0]:.2f}x its bound; "
                      f"max_abs_err {e:.3g}; bit-equal to the same heads of the {H}-head "
                      f"call: {bit}")
                out[what].append(dict(case=f"{name} model={tp}", shape=list(shape),
                                      ms=times[kernel], plain_ms=times[plain], bound_ms=bound[0],
                                      bound_by=bound[1], library_ms=times[lib], max_abs_err=e,
                                      bit_equal_to_full=bit,
                                      **({"mma_ms": times["bwd_mma"]} if mma else {})))
            del qr, kr, vr, dor, o, grads, qt, kt, vt, ot, dot
        del q, k, v, do, o_all, grads_all
        torch.cuda.empty_cache()
    return out


def sharding_policy_phase(torch, dev, fa, ops, ssd, smi_line: str) -> dict:
    """The policy path at model = 1 (a), pad_heads at model = 16 (b), the
    policy path of the ssm, hybrid and encdec families at model = 1 (c),
    the kernels at the per-rank shapes of model = 2 and 4 (d). Returns
    (d)'s numbers by kernel."""
    t0 = time.perf_counter()
    phase("sharding policy")
    policy_path_checks(torch, dev, fa, smi_line)
    padded_head_checks(torch, dev, fa)
    padded_wgmma_times(torch, dev, fa, smi_line)
    t_c = time.perf_counter()
    policy_family_checks(torch, dev, fa, ssd, smi_line)
    t_d = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(34)
    per_rank = {**tp_ssd_times(torch, dev, gen, ops, ssd, smi_line),
                **tp_flash_times(torch, dev, gen, fa, ops, smi_line)}
    t_end = time.perf_counter()
    print(f"sharding policy: phase took {t_end - t0:.1f} s ((c) {t_d - t_c:.1f} s, "
          f"(d) {t_end - t_d:.1f} s)")
    return per_rank


def stand_in_tensors(tree) -> list:
    """Every tensor of a bundle's ``args`` (dicts, tuples, ``AdamWState``)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in stand_in_tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in stand_in_tensors(v)]
    if dataclasses.is_dataclass(tree):
        return stand_in_tensors([getattr(tree, f.name) for f in dataclasses.fields(tree)])
    return [tree]


def stand_in_checks(torch, dev) -> int:
    """(a): every cell of the shape table on both production meshes built
    as a bundle of meta-device stand-ins, the card's allocated memory the
    same before and after. Returns the count of bundles."""
    from repro_torch.configs import all_cells
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_bundle

    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    n = leaves = elements = 0
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch, shape, _, _ in all_cells():
            tensors = stand_in_tensors(build_bundle(arch, shape, mesh).args)
            if not all(t.device.type == "meta" for t in tensors):
                fail(f"a stand-in of {arch} x {shape} on {mesh.shape} is not on meta")
            n, leaves = n + 1, leaves + len(tensors)
            elements += sum(t.numel() for t in tensors)
    torch.cuda.synchronize(dev)
    after = torch.cuda.memory_allocated(dev)
    print(f"  stand-ins: {n} bundles (40 cells x 2 production meshes) in "
          f"{time.perf_counter() - t0:.2f} s, {leaves} meta tensors of {elements:.4g} "
          f"elements; memory_allocated {before} -> {after} B")
    if n != 80 or after != before:
        fail(f"{n} bundles, memory_allocated {before} -> {after}: want 80 and no change")
    return n


def bundle_train_checks(torch, dev, fa, smi_line: str) -> dict:
    """(b): the train kind at each of ``STEPS_ACCUMS`` on train_lm's first
    step's params and batch: the first step's loss against
    ``Trainer.step``'s, accum 2 against accum 1, the undivided gradient sum
    as a planted fault that must fail that check; then ``STEPS_TIMED``
    timed steps with the flash launches counted. Returns the launches a
    step by accum."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import _batch_for_step
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train_lm import DATA_SEED, Trainer, clone_params
    from repro_torch.models import LM
    from repro_torch.optim import adamw_init, cosine_schedule

    cfg = get_config(STEPS_ARCH)
    S, B = STEPS_SHAPE
    shape = ShapeSpec("train_1k", S, B, "train")
    mesh = make_test_mesh(data=1, model=1)
    params = LM(cfg, device=dev).init(0, param_dtype=torch.float32)
    batch = {k: torch.from_numpy(v).to(dev, torch.int64)
             for k, v in _batch_for_step(DATA_SEED, 0, B, S, cfg.vocab_size).items()}
    trainer = Trainer(LM(cfg, device=dev, remat=True), params, 1, "builtin",
                      cosine_schedule(3e-4, warmup=20, total=100))
    want_loss, want_gnorm = trainer.step(batch)
    del trainer
    torch.cuda.empty_cache()

    def first_step(accum: int) -> dict:
        bundle = steps.build_bundle(STEPS_ARCH, shape, mesh, accum_steps=accum)
        placed = bundle.lm.policy.param_shardings(clone_params(params))
        _, _, metrics = bundle.fn(placed, adamw_init(placed), batch)
        return {k: float(full(v)) for k, v in metrics.items()}

    first = {a: first_step(a) for a in STEPS_ACCUMS}
    one, two = first[1], first[2]
    rel = abs(one["loss"] - want_loss) / abs(want_loss)
    print(f"  train {STEPS_ARCH} {B}x{S} (f32 masters, bf16 compute copies): accum 1 loss "
          f"{one['loss']:.6f} vs Trainer.step's {want_loss:.6f} (rel {rel:.3g}, tol "
          f"{STEPS_LOSS_REL_TOL}); grad norm {one['grad_norm']:.6f} vs {want_gnorm:.6f} "
          f"(differentiated at the f32 masters)")
    if not (rel <= STEPS_LOSS_REL_TOL and finite(*one.values())):
        fail("the bundle's first training step disagrees with Trainer.step's loss")

    def accum_agrees(got: dict) -> tuple:
        rl = abs(got["loss"] - one["loss"]) / abs(one["loss"])
        rg = abs(got["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
        return rl, rg, rl <= STEPS_LOSS_REL_TOL and rg <= STEPS_GNORM_REL_TOL

    rl, rg, ok = accum_agrees(two)
    print(f"  accum 2 vs 1: loss {two['loss']:.6f} vs {one['loss']:.6f} (rel {rl:.3g}, tol "
          f"{STEPS_LOSS_REL_TOL}), xent {two['xent']:.6f} vs {one['xent']:.6f}, grad norm "
          f"{two['grad_norm']:.6f} vs {one['grad_norm']:.6f} (rel {rg:.3g}, tol "
          f"{STEPS_GNORM_REL_TOL}), lr {two['lr']:.4g}")
    if not (ok and finite(*two.values())):
        fail("the bundle's accum 2 step disagrees with its accum 1 step")
    keep = steps.mean_of_sum
    steps.mean_of_sum = lambda gsum, n: gsum  # planted: the sum not divided by accum
    try:
        faulty = first_step(2)
    finally:
        steps.mean_of_sum = keep
    rl, rg, ok = accum_agrees(faulty)
    print(f"  planted fault (the f32 gradient sum not divided by accum): grad norm "
          f"{faulty['grad_norm']:.6f} (rel {rg:.3g}) {'PASSED: FAIL' if ok else 'fails, as it must'}")
    if ok:
        fail("the accum check passed the undivided gradient sum")

    counters = flash_counters(fa)
    launches = {}
    for accum in STEPS_ACCUMS:
        bundle = steps.build_bundle(STEPS_ARCH, shape, mesh, accum_steps=accum)
        placed = bundle.lm.policy.param_shardings(clone_params(params))
        opt = adamw_init(placed)
        bundle.fn(placed, opt, batch)  # warm-up
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        step_ms, losses = [], []
        for _ in range(STEPS_TIMED):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, _, metrics = bundle.fn(placed, opt, batch)
            torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(full(metrics["loss"])))
        peak = torch.cuda.max_memory_allocated(dev)
        counted = {c.__name__: c.launches for c in counters}
        L = cfg.num_layers
        want = {"flash_attention": 2 * L * accum * STEPS_TIMED,
                "flash_attention_wgmma": 2 * L * accum * STEPS_TIMED,
                "flash_attention_mma": 0, "flash_attention_wide": 0,
                **bwd_want(fa, L * accum * STEPS_TIMED, cfg.head_dim, cfg.dtype)}
        print(f"steps train accum={accum} ({smi_line}): step_ms={statistics.median(step_ms):.3f} "
              f"(median of {STEPS_TIMED}: {', '.join(f'{x:.3f}' for x in step_ms)}) "
              f"max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB) loss "
              f"{', '.join(f'{x:.6f}' for x in losses)}; launches a step: wgmma "
              f"{counted['flash_attention_wgmma'] / STEPS_TIMED:g}, backward "
              f"{counted['flash_attention_bwd'] / STEPS_TIMED:g}")
        if counted != want:
            fail(f"flash launches over {STEPS_TIMED} bundle steps at accum {accum} {counted}, "
                 f"want {want} (a microbatch: the forward once a layer and again in "
                 f"remat's recompute, the backward once)")
        if not finite(*losses):
            fail("a bundle step's loss is not finite")
        launches[accum] = {k: n // STEPS_TIMED for k, n in counted.items()}
        del bundle, placed, opt
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return launches


def bundle_serve_checks(torch, dev, fa) -> int:
    """(c): the prefill kind at ``STEPS_SHAPE`` and one step of the decode
    kind over the prefill's cache, each bit for bit the same as ``LM``
    without a policy on the same f32 params; the prefill's flash launches
    counted. Returns them."""
    from repro_torch.bridge import named_leaves
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import LM

    cfg = get_config(STEPS_ARCH)
    S, B = STEPS_SHAPE
    mesh = make_test_mesh(data=1, model=1)
    plain = LM(cfg, device=dev)
    params = plain.init(0, param_dtype=torch.float32)
    prompts = torch.from_numpy(make_prompts(B, S, cfg.vocab_size, 0)).to(dev)
    pre = steps.build_bundle(STEPS_ARCH, ShapeSpec("prefill_1k", S, B, "prefill"), mesh)
    placed = pre.lm.policy.param_shardings(params)
    pre.fn(placed, {"tokens": prompts})  # warm-up
    counters = flash_want(fa, wgmma=cfg.num_layers)
    for c in counters:
        c.launches = 0
    got = full(pre.fn(placed, {"tokens": prompts}))
    counted = {c: c.launches for c in counters}
    with torch.no_grad():
        want = plain.forward_logits(params, prompts)
    same_prefill = torch.equal(got, want)
    nxt = want[:, -1].argmax(-1)
    del got, want
    dec = steps.build_bundle(STEPS_ARCH, ShapeSpec("decode_1k", S + 1, B, "decode"), mesh)
    with torch.no_grad():
        _, cache = dec.lm.prefill(placed, prompts, max_seq=S + 1)
        _, plain_cache = plain.prefill(params, prompts, max_seq=S + 1)
    layout = [(p, tuple(t.shape), t.dtype) for p, t in named_leaves(cache)]
    if layout != [(p, tuple(t.shape), t.dtype) for p, t in named_leaves(dec.args[1])]:
        fail("the decode bundle's cache stand-ins differ from the cache a prefill lays out")
    got, _ = dec.fn(placed, cache, nxt, torch.tensor(S))
    with torch.no_grad():
        want, _ = plain.decode_step(params, plain_cache, nxt, S)
    same_decode = torch.equal(full(got), want)
    print(f"  prefill {B}x{S}: logits bit-equal to LM without a policy {same_prefill}, "
          f"wgmma launches {counted[fa.flash_attention_wgmma]} (want {cfg.num_layers}); "
          f"decode step at {S}: logits bit-equal {same_decode}; the decode bundle's "
          f"{len(layout)} cache stand-ins match the prefill's cache")
    if counted != counters:
        fail(f"flash launches of the prefill bundle "
             f"{({c.__name__: n for c, n in counted.items()})}, want "
             f"{({c.__name__: n for c, n in counters.items()})}")
    if not (same_prefill and same_decode):
        fail("the prefill or decode bundle is not bit-equal to LM without a policy")
    del params, placed, cache, plain_cache
    torch.cuda.empty_cache()
    return counted[fa.flash_attention_wgmma]


def steps_phase(torch, dev, fa, smi_line: str, group=one_rank_nccl_group) -> dict:
    """launch/steps.py on the card: (a) the stand-ins, (b) the train kind,
    (c) the prefill and decode kinds, on a one-rank group. Returns the
    launches a step for the kernels line."""
    t0 = time.perf_counter()
    phase("steps")
    end = group(torch)
    try:
        stand_in_checks(torch, dev)
        train = bundle_train_checks(torch, dev, fa, smi_line)
        prefill = bundle_serve_checks(torch, dev, fa)
    finally:
        end()
    print(f"steps: phase took {time.perf_counter() - t0:.1f} s")
    return {"wgmma": {**{f"train_accum{a}": n["flash_attention_wgmma"]
                         for a, n in train.items()}, "prefill": prefill},
            "bwd": {f"train_accum{a}": n["flash_attention_bwd"] for a, n in train.items()}}


def launch_train_checks(torch, dev, fa, smi_line: str, cfg=None, shape=LAUNCH_SHAPE,
                        steps: int = LAUNCH_STEPS) -> dict:
    """(a): ``launch.train.train`` of ``cfg`` (default: full-width
    LAUNCH_ARCH) at ``shape`` (seq_len, global_batch) for ``steps`` steps
    on the current group, the flash launches counted over the whole run:
    its first loss against ``Trainer.step``'s on the same params (seed 0,
    f32) and batch (the pipeline's batch 0), bit for bit; a pipeline
    started one batch late as a planted fault that must fail that check.
    Prints the step ms (median of steps 1 on), the peak memory, the
    straggler verdicts and the losses. Returns the launches a step."""
    import shutil
    import tempfile

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import _batch_for_step
    from repro_torch.launch import train as launcher
    from repro_torch.launch.train_lm import Trainer
    from repro_torch.models import LM
    from repro_torch.optim import cosine_schedule

    cuda = dev.type == "cuda"
    cfg = cfg or get_config(LAUNCH_ARCH)
    S, B = shape
    spec = ShapeSpec(f"train_{S}", S, B, "train")
    trainer = Trainer(LM(cfg, device=dev, remat=True),
                      LM(cfg, device=dev).init(0, param_dtype=torch.float32), 1, "builtin",
                      cosine_schedule(3e-4, warmup=1, total=100))
    batch = {k: torch.from_numpy(v).to(dev, torch.int64)
             for k, v in _batch_for_step(0, 0, B, S, cfg.vocab_size).items()}
    want_loss, want_gnorm = trainer.step(batch)
    del trainer, batch
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ckpt = tempfile.mkdtemp()
    counters = flash_counters(fa)
    try:
        for c in counters:
            c.launches = 0
        lines = []
        t0 = time.perf_counter()
        out = launcher.train(cfg, spec, steps=steps, ckpt_dir=ckpt, device=dev,
                             log=lines.append)
        wall = time.perf_counter() - t0
        counted = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        saved = sorted(os.listdir(ckpt))
        del out["params"], out["opt"]
        if cuda:
            torch.cuda.empty_cache()
        real = launcher.DataPipeline
        launcher.DataPipeline = lambda **kw: real(**{**kw, "start_step": kw["start_step"] + 1})
        try:  # planted: the pipeline one batch late
            faulty = launcher.train(cfg, spec, steps=1, ckpt_dir=ckpt, device=dev,
                                    log=lambda line: None)["loss"][0]
        finally:
            launcher.DataPipeline = real
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses, ms = out["loss"], [x * 1e3 for x in out["step_s"]]
    got_loss, got_gnorm = losses[0], out["grad_norm"][0]
    rg = abs(got_gnorm - want_gnorm) / abs(want_gnorm)
    print(f"  train {cfg.name} {B}x{S} through launch.train ({out['mesh'].axis_sizes}, "
          f"f32 params and AdamW, remat): first loss {got_loss!r} vs Trainer.step's "
          f"{want_loss!r} ({'bit-equal' if got_loss == want_loss else 'DIFFERENT'}), grad "
          f"norm {got_gnorm!r} vs {want_gnorm!r} (rel {rg:.3g}, tol {LAUNCH_GNORM_REL_TOL})")
    print(f"  planted fault (the pipeline one batch late): first loss {faulty!r} "
          f"{'PASSED: FAIL' if faulty == want_loss else 'fails, as it must'}")
    L = cfg.num_layers
    want = {"flash_attention": 2 * L * steps, "flash_attention_wgmma": 2 * L * steps,
            "flash_attention_mma": 0, "flash_attention_wide": 0,
            **bwd_want(fa, L * steps, cfg.head_dim, cfg.dtype)}
    median = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
    print(f"launch train ({smi_line}): {steps} steps in {wall:.2f} s, step_ms={median:.3f} "
          f"(median of steps 1-{steps - 1}: {fmt_ms(ms[1:])}; step 0 {ms[0]:.3f}) "
          f"max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB); launches a step: wgmma "
          f"{counted['flash_attention_wgmma'] / steps:g}, backward "
          f"{counted['flash_attention_bwd'] / steps:g}; verdicts {out['verdict']}; losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}")
    for line in lines:
        print(f"    {line}")
    if got_loss != want_loss or not rg <= LAUNCH_GNORM_REL_TOL:
        fail("the launcher's first step disagrees with Trainer.step's")
    if faulty == want_loss:
        fail("the first-loss check passed a pipeline started one batch late")
    if counted != want:
        fail(f"flash launches over {steps} launcher steps {counted}, want {want} (a step: "
             f"the forward once a layer and again in remat's recompute, the backward once)")
    if len(losses) != steps or out["start_step"] != 0 or not finite(*losses, *out["grad_norm"]):
        fail(f"the launcher ran {len(losses)} steps from {out['start_step']}, losses {losses}")
    if saved:
        fail(f"{steps} steps saved {saved}: the reference's cadence saves first after step 10")
    if not (lines[0].startswith(f"arch={cfg.name} (") and lines[-1] == "done"):
        fail(f"the launcher logged {lines[0]!r} ... {lines[-1]!r}")
    return {"wgmma": counted["flash_attention_wgmma"] // steps,
            "bwd": counted["flash_attention_bwd"] // steps}


def launch_serve_checks(torch, dev, fa, argv=LAUNCH_SERVE_ARGV) -> int:
    """(b): ``launch.serve.main(argv)`` under the launch group's mesh and
    policy, its ``serve()`` output captured, the flash launches counted over
    the whole run; its tokens and prefill and last logits bit for bit
    against ``serve()`` on ``LM`` without a policy (the same config, seed 0,
    prompts and stub inputs). Returns the wgmma launches."""
    from repro_torch.launch import serve as launcher
    from repro_torch.models import LM

    caught = []
    real = launcher.serve

    def capture(lm, params, prompts, new_tokens, **stub):
        out = real(lm, params, prompts, new_tokens, **stub)
        caught.append((lm, prompts, new_tokens, stub, out))
        return out

    launcher.serve = capture
    counters = {c: 0 for c in flash_counters(fa)}
    try:
        for c in counters:
            c.launches = 0
        rc = launcher.main(argv)
        counters = {c: c.launches for c in counters}
    finally:
        launcher.serve = real
    (lm, prompts, new, stub, got), = caught
    plain = LM(lm.cfg, device=dev)
    want = real(plain, plain.init(0), prompts, new, **stub)
    same = {k: torch.equal(full(got[k]), want[k])
            for k in ("tokens", "prefill_logits", "last_logits")}
    L = lm.cfg.num_layers
    print(f"  serve.main {' '.join(argv)}: rc {rc}, policy on {lm.policy.mesh.axis_sizes}, "
          f"bit-equal to serve() without a policy {same}; prefill {got['prefill_s'] * 1e3:.2f}"
          f" ms, decode {got['decode_s'] * 1e3 / max(new, 1):.3f} ms a step (without: "
          f"{want['prefill_s'] * 1e3:.2f}, {want['decode_s'] * 1e3 / max(new, 1):.3f}); wgmma "
          f"launches {counters[fa.flash_attention_wgmma]} (want {L})")
    wanted = {c: 0 for c in counters}
    wanted.update({fa.flash_attention: L, fa.flash_attention_wgmma: L})
    if rc != 0 or lm.policy is None:
        fail(f"serve.main returned {rc} (policy {lm.policy})")
    if counters != wanted:
        fail(f"flash launches of serve.main {({c.__name__: n for c, n in counters.items()})}, "
             f"want {L} on the wgmma route")
    if not all(same.values()):
        fail(f"serve.main under the policy is not bit-equal to serve() without it: {same}")
    return counters[fa.flash_attention_wgmma]


def launch_phase(torch, dev, fa, smi_line: str, group=one_rank_nccl_group,
                 cfg=None, shape=LAUNCH_SHAPE, steps: int = LAUNCH_STEPS,
                 serve_argv=LAUNCH_SERVE_ARGV) -> dict:
    """launch/train.py and serve.py's mesh and policy on the card: (a) the
    training launcher, (b) the serving launcher, in a one-rank group.
    Returns the launches for the kernels line."""
    t0 = time.perf_counter()
    phase("launch")
    end = group(torch)
    try:
        train = launch_train_checks(torch, dev, fa, smi_line, cfg, shape, steps)
        prefill = launch_serve_checks(torch, dev, fa, serve_argv)
    finally:
        end()
    print(f"launch: phase took {time.perf_counter() - t0:.1f} s")
    return {"wgmma": {"train_step": train["wgmma"], "serve_prefill": prefill},
            "bwd": {"train_step": train["bwd"]}}


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds a call of ``fn``: ``calls`` calls issued back to
    back (the card runs behind), after one call and a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def op_checks(torch, dev, fa, ops, ssd, smi_line: str) -> dict:
    """(a): each kernel through its ``torch.library`` operator
    (``kernels/ops``) twice, bit for bit against its wrapper called
    directly, and against its plain version at the check's tolerance; the
    host time a call through the operator beside the wrapper's. Returns
    the numbers by kernel."""
    from repro_torch.kernels.ref import (
        flash_attention_bwd_ref,
        flash_attention_ref,
        ssd_scan_bwd_ref,
        ssd_scan_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    (q, k, v), _ = attention_inputs(torch, gen, dev, SLICE_SHAPE, "bfloat16")
    o = fa.flash_attention(q, k, v, causal=True)
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    B, S, H, P, N, chunk = SSD_SLICE
    xs = ssd_inputs(torch, gen, dev, B, S, H, P, N)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)

    def ssd_direct():
        return ssd.ssd_scan(*xs, chunk=chunk, state_out=state), state

    B, S, H, P, N, bchunk = SSD_BWD_SHAPES["mamba2-370m"]
    bx = (*ssd_inputs(torch, gen, dev, B, S, H, P, N),
          torch.randn((B, S, H, P), generator=gen, device=dev))
    cases = {  # name: (through the operator, the wrapper, the plain version, check, tol)
        "flash_attention": (lambda: ops.flash_attention(q, k, v, causal=True),
                            lambda: fa.flash_attention(q, k, v, causal=True),
                            lambda: flash_attention_ref(q, k, v, causal=True),
                            compare, BF16_TOL),
        "flash_attention_bwd": (lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=True),
                                lambda: fa.flash_attention_bwd(q, k, v, o, do, causal=True),
                                lambda: flash_attention_bwd_ref(q, k, v, o, do, causal=True),
                                compare, BF16_TOL),
        "ssd_scan": (lambda: ops.ssd_scan(*xs, chunk=chunk, return_state=True), ssd_direct,
                     lambda: ssd_scan_ref(*xs, return_state=True), compare, SSD_TOL),
        "ssd_scan_bwd": (lambda: ops.ssd_scan_bwd(*bx, chunk=bchunk),
                         lambda: ssd.ssd_scan_bwd(*bx, chunk=bchunk),
                         lambda: ssd_scan_bwd_ref(*bx, chunk=bchunk),
                         compare_scaled, SSD_BWD_TOL),
    }
    out = {}
    for name, (op_fn, direct_fn, plain_fn, check, tol) in cases.items():
        first = [t.clone() for t in as_tuple(op_fn())]
        second = as_tuple(op_fn())
        direct = as_tuple(direct_fn())
        same = all(torch.equal(a, c) and torch.equal(b, c)
                   for a, b, c in zip(first, second, direct))
        checked = [check(g, w, tol) for g, w in zip(first, as_tuple(plain_fn()))]
        ok = all(c[1] for c in checked)
        times = {"op": [], "wrapper": []}
        for _ in range(3):  # in turns
            times["op"].append(host_us(torch, op_fn))
            times["wrapper"].append(host_us(torch, direct_fn))
        op_us, wrapper_us = (statistics.median(times[key]) for key in ("op", "wrapper"))
        print(f"  {name} through torch.ops.repro_torch ({smi_line}): two calls bit-equal to "
              f"the wrapper's {same}; max_abs_err vs plain "
              f"{' / '.join(f'{c[0]:.3g}' for c in checked)} (tol {tol}) "
              f"{'ok' if ok else 'FAIL'}; host {op_us:.1f} us a call through the operator, "
              f"{wrapper_us:.1f} us the wrapper alone (+{op_us - wrapper_us:.1f} us)")
        if not same:
            fail(f"{name} through its operator is not bit-equal to its wrapper")
        if not ok:
            fail(f"{name} through its operator disagrees with its plain version")
        out[name] = {"op_host_us": op_us, "wrapper_host_us": wrapper_us,
                     "max_abs_err": max(c[0] for c in checked)}
        del first, second, direct
    del q, k, v, o, do, xs, state, bx
    torch.cuda.empty_cache()
    return out


def fill_args(torch, dev, args, vocab: int) -> None:
    """Values for the placed (uninitialised) arguments of a bundle step:
    floats ~ N(0, 0.02), token ids in the vocabulary, the AdamW moments 0."""
    from repro_torch.launch.op_cost import local_tensors
    from repro_torch.optim import AdamWState

    gen = torch.Generator(device=dev).manual_seed(0)
    for arg in args:
        zero = isinstance(arg, AdamWState)
        for t in local_tensors(arg):
            if zero:
                t.zero_()
            elif t.is_floating_point():
                t.normal_(0.0, 0.02, generator=gen)
            else:
                t.random_(0, vocab, generator=gen)


def card_step(torch, dev, kind: str, accum) -> dict:
    """One kind of the bundle at ``DRYRUN_SHAPE`` on the card, at 1 x 1:
    its arguments placed as the dry run places them and filled
    (``fill_args``), one warm-up step, then ``DRYRUN_TIMED`` timed steps
    with the peak memory above what was allocated before the arguments."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.op_cost import local_tensors

    S, B = DRYRUN_SHAPE
    bundle = steps.build_bundle(DRYRUN_ARCH, ShapeSpec(f"{kind}_{S}", S, B, kind),
                                make_test_mesh(1, 1), accum_steps=accum)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    args = dryrun.place_args(bundle, dev)
    fill_args(torch, dev, args, bundle.cfg.vocab_size)
    torch.cuda.synchronize(dev)
    got = {"argument_bytes": dryrun.storage_bytes(local_tensors(args)),
           "argument_allocated": torch.cuda.memory_allocated(dev) - base}
    out = bundle.fn(*args)  # warm-up
    del out
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = []
    for _ in range(DRYRUN_TIMED):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = bundle.fn(*args)
        torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        del out
    got.update(peak=torch.cuda.max_memory_allocated(dev) - base, step_ms=step_ms)
    del args, bundle
    torch.cuda.empty_cache()
    return got


def start_child(argv: list, log: Path, cwd: Path):
    """A child process of this phase, its output to ``log``."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")])}
    cwd.mkdir(parents=True, exist_ok=True)
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, *argv], cwd=cwd, env=env, stdout=f,
                                stderr=subprocess.STDOUT)


def wait_child(proc, log: Path, what: str, t_end: float) -> int:
    try:
        rc = proc.wait(timeout=max(1.0, t_end - time.perf_counter()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"{what} did not end within {DRYRUN_CHILD_LIMIT} s")
    if rc != 0:
        print(log.read_text()[-3000:])
    return rc


def predicted_against_card(torch, dev, measured: dict, predicted: dict,
                           smi_line: str) -> None:
    """(b)'s lines and checks: argument bytes equal, the predicted peak
    within ``DRYRUN_PEAK_GAP``, FLOPs over the step's median time."""
    for name, _, _ in DRYRUN_KINDS:
        rec, got = predicted[name], measured[name]
        if rec.get("status") != "ok":
            fail(f"the dry run of {DRYRUN_ARCH} {name} at 1 x 1: {rec.get('error')}")
        mem = rec["memory"]
        pred_peak = mem["argument_bytes"] + mem["temp_bytes"]
        gap = (got["peak"] - pred_peak) / got["peak"]
        ms = statistics.median(got["step_ms"])
        print(f"  {DRYRUN_ARCH} {name} {DRYRUN_SHAPE[1]}x{DRYRUN_SHAPE[0]} at 1 x 1 "
              f"({smi_line}): argument bytes predicted {mem['argument_bytes']}, on the card "
              f"{got['argument_bytes']} (allocator {got['argument_allocated']}); argument + "
              f"temp {pred_peak} B ({pred_peak / 2**30:.3f} GiB) vs max_memory_allocated "
              f"{got['peak']} B ({got['peak'] / 2**30:.3f} GiB): gap {gap:+.2%} (limit "
              f"{DRYRUN_PEAK_GAP:.0%}); {rec['flops'] / 1e12:.4g} TFLOP predicted, step "
              f"{ms:.3f} ms (median of {', '.join(f'{x:.3f}' for x in got['step_ms'])}): "
              f"{rec['flops'] / ms / 1e9:.2f} TFLOP/s achieved; trace {rec['trace_s']} s")
        if mem["argument_bytes"] != got["argument_bytes"]:
            fail(f"the dry run's argument bytes of {name} differ from the card's")
        if abs(gap) > DRYRUN_PEAK_GAP:
            fail(f"the dry run's peak of {name} misses max_memory_allocated by {gap:+.2%}")


def pod_lines(torch, dev, records: dict, source: str, smi_line: str) -> int:
    """(c)'s lines and checks for the records of one child: status, FLOPs
    and collective bytes per device, the predicted peak against the card's
    memory, trace seconds; device memory unchanged. Returns the cells."""
    total = torch.cuda.get_device_properties(dev).total_memory
    for key, rec in records.items():
        if rec["status"] == "skipped":
            print(f"  {source} {key}: skipped ({rec['reason']})")
            continue
        if rec["status"] != "ok":
            print(rec.get("traceback", ""))
            fail(f"the dry run of {key} ({source}): {rec.get('error')}")
        mem = rec["memory"]
        peak = mem["argument_bytes"] + mem["temp_bytes"]
        colls = ", ".join(f"{k} {v / 2**20:.1f} MiB x{rec['collective_counts'][k]}"
                          for k, v in rec["collective_bytes"].items())
        before, after = rec.get("device_allocated_bytes", [None, None])
        print(f"  {source} {key} ({smi_line}): ok, {rec['flops'] / 1e12:.4g} TFLOP and "
              f"{rec['bytes_accessed'] / 1e9:.4g} GB a device; collectives {colls}; "
              f"argument + temp {peak / 2**30:.2f} GiB of the card's {total / 2**30:.2f} GiB "
              f"({'fits' if peak <= total else 'does not fit'}); trace {rec['trace_s']} s, "
              f"cell {rec['total_s']} s; memory_allocated {before} -> {after}")
        if before != after:
            fail(f"the dry run of {key} allocated on the card: {before} -> {after}")
    return len(records)


def dryrun_phase(torch, dev, fa, ops, ssd, smi_line: str, group=one_rank_nccl_group) -> dict:
    """launch/dryrun.py and the kernels' operators on the card: (a) the
    operators against the wrappers, (b) the prediction against the card,
    (c) the production dry run on fake CUDA tensors. The child processes
    of (b) and (c) start after (a) and run beside (b)'s steps on the card.
    Returns (a)'s numbers for the kernels line."""
    import tempfile

    t0 = time.perf_counter()
    phase("dryrun")
    per_op = op_checks(torch, dev, fa, ops, ssd, smi_line)
    t_a = time.perf_counter()
    where = Path(tempfile.mkdtemp())
    S, B = DRYRUN_SHAPE
    kinds = json.dumps([list(k) for k in DRYRUN_KINDS])
    children = {  # name: (argv, cwd)
        "predict": (["-c", PREDICT_CHILD, DRYRUN_ARCH, str(S), str(B), kinds,
                     str(where / "predict.json")], where / "predict"),
        "dryrun": (["-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_ARCH, "--mesh", "pod",
                    "--out", str(where / "pod.json")], where / "dryrun"),
        "train": (["-m", "repro_torch.launch.train", "--dry-run", "--arch", DRYRUN_ARCH],
                  where / "train"),
        "serve": (["-m", "repro_torch.launch.serve", "--dry-run", "--arch", DRYRUN_ARCH],
                  where / "serve"),
    }
    procs = {name: start_child(argv, where / f"{name}.log", cwd)
             for name, (argv, cwd) in children.items()}
    t_end = time.perf_counter() + DRYRUN_CHILD_LIMIT
    try:
        end = group(torch)
        try:
            measured = {name: card_step(torch, dev, kind, accum)
                        for name, kind, accum in DRYRUN_KINDS}
        finally:
            end()
        t_b = time.perf_counter()
        rcs = {name: wait_child(proc, where / f"{name}.log", name, t_end)
               for name, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    t_c = time.perf_counter()
    if rcs["predict"] != 0:
        fail(f"the prediction's child process exited {rcs['predict']}")
    predicted_against_card(torch, dev, measured, json.loads(
        (where / "predict.json").read_text()), smi_line)
    if rcs["dryrun"] != 0:
        fail(f"python -m repro_torch.launch.dryrun --mesh pod exited {rcs['dryrun']}")
    pod = json.loads((where / "pod.json").read_text())
    want = {f"{DRYRUN_ARCH}|{shape}|pod" for shape in DRYRUN_POD_SHAPES}
    if set(pod) != want or pod[f"{DRYRUN_ARCH}|long_500k|pod"]["status"] != "skipped":
        fail(f"the pod dry run recorded {sorted(pod)}, want {sorted(want)} with long_500k "
             f"skipped")
    cells = pod_lines(torch, dev, pod, "dryrun", smi_line)
    for name in ("train", "serve"):
        if rcs[name] != 0:
            fail(f"launch.{name} --dry-run exited {rcs[name]}")
        recs = json.loads((where / name / "results" / "dryrun_torch.json").read_text())
        cells += pod_lines(torch, dev, recs, f"launch.{name} --dry-run", smi_line)
    print(f"dryrun: phase took {time.perf_counter() - t0:.1f} s ((a) {t_a - t0:.1f} s; (b)'s "
          f"steps on the card {t_b - t_a:.1f} s; the child processes, started after (a), "
          f"done {t_c - t_a:.1f} s after it; {cells} production cells on fake CUDA tensors)")
    import shutil

    shutil.rmtree(where, ignore_errors=True)
    return per_op


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import (
        flash_attention_bwd_ref,
        flash_attention_ref,
        ssd_scan_bwd_ref,
        ssd_scan_ref,
    )
    from repro_torch.models import LM

    # 1. the card --------------------------------------------------------
    phase("card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 2. build -------------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    fault_build = start_wgmma_fault_build(build)  # beside the seven sources
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {sorted(logs)} in {build_s:.1f} s")
    for name, log in logs.items():
        if name in ("flash_attention_bwd", "flash_attention_bwd_wgmma", "ssd_scan_bwd"):
            continue  # by pass below
        for line in log.splitlines():
            if any(key in line for key in ("registers", "spill", "(C75")):
                print(f"  {name}: {line.strip()}")
    for route in ("flash_attention_bwd", "flash_attention_bwd_wgmma"):
        for row in bwd_ptxas(logs[route]):
            print(f"  ptxas, backward: {row}")
    wgmma_bwd = bwd_ptxas(logs["flash_attention_bwd_wgmma"])
    if len([r for r in wgmma_bwd if "registers" in r]) != 6 or any(
            "spill stores 0 B, loads 0 B" not in r for r in wgmma_bwd if "registers" in r):
        fail(f"the wgmma backward's 6 passes (3 at hd 64 and 128) must build without "
             f"spills: {wgmma_bwd}")
    for row in ssd_bwd_ptxas(logs["ssd_scan_bwd"]):
        print(f"  ptxas, SSD backward: {row}")

    # 3. both flash routes against their plain version ---------------------
    phase("kernel checks")
    gen = torch.Generator(device=dev).manual_seed(0)
    routes = {"wgmma": fa.flash_attention_wgmma, "mma": fa.flash_attention_mma,
              "wide": fa.flash_attention_wide}

    def fused_qkv(B, S, H, KV, hd, dtype):
        qkv = torch.randn((B, S, (H + 2 * KV) * hd), generator=gen, device=dev).to(dtype)
        return (qkv[..., :H * hd].reshape(B, S, H, hd),
                qkv[..., H * hd:(H + KV) * hd].reshape(B, S, KV, hd),
                qkv[..., (H + KV) * hd:].reshape(B, S, KV, hd))

    slice_err = {}
    cases = [(case, False) for case in CHECK_CASES] + [
        ((B, S, S, H, KV, hd, dt, kw), True) for B, S, H, KV, hd, dt, kw in FUSED_CASES]
    for (B, S, T, H, KV, hd, dt, kw), fused in cases:
        dtype = getattr(torch, dt)
        if fused:
            q, k, v = fused_qkv(B, S, H, KV, hd, dtype)
        else:
            q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
            k = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(dtype)
            v = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(dtype)
        route = fa.route(dtype, hd)
        before = {r: fn.launches for r, fn in routes.items()}
        got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        counted = {r: fn.launches - before[r] for r, fn in routes.items()}
        want = flash_attention_ref(q, k, v, **kw)
        tol = F32_TOL if dt == "float32" else BF16_TOL
        err, ok = compare(got, want, tol)
        print(f"  {route}: B={B} S={S} T={T} H={H} KV={KV} hd={hd} {dt} {kw}"
              f"{' fused qkv view' if fused else ''}: max_abs_err={err:.3g} "
              f"(tol {tol}) {'ok' if ok else 'FAIL'}")
        if counted != {r: int(r == route) for r in routes}:
            fail(f"launches by route {counted}: want one on the {route} route")
        if not (ok and torch.isfinite(got).all()):
            fail(f"kernel disagrees with its plain version at {(B, S, T, H, KV, hd, dt, kw)}")
        if (B, S, H, KV, hd) == SLICE_SHAPE and not fused:
            slice_err[dt] = err
    wgmma_fault_checks(torch, gen, dev, fa, ops, fault_build, flash_attention_ref)

    # both routes at the serving shape: wgmma (bf16), mma (f32, its route;
    # and bf16, a yardstick beside wgmma that nothing here serves)
    slice_in = {dt: attention_inputs(torch, gen, dev, SLICE_SHAPE, dt)
                for dt in ("bfloat16", "float32")}

    def kernel_fn(fn, dt):
        q, k, v = slice_in[dt][0]
        return lambda: fn(q, k, v, causal=True)

    def sdpa_fn(dt):
        qt, kt, vt = slice_in[dt][1]
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)

    torch.testing.assert_close(sdpa_fn("bfloat16")().transpose(1, 2).float(),
                               kernel_fn(ops.flash_attention, "bfloat16")().float(),
                               rtol=BF16_TOL, atol=BF16_TOL)
    timed = {  # name: (function, launches a round)
        "wgmma": (kernel_fn(ops.flash_attention, "bfloat16"), 100),
        "plain_bf16": (kernel_fn(flash_attention_ref, "bfloat16"), 5),
        "sdpa_bf16": (sdpa_fn("bfloat16"), 100),
        "mma_bf16": (kernel_fn(fa.flash_attention_mma, "bfloat16"), 50),
        "mma": (kernel_fn(ops.flash_attention, "float32"), 50),
        "plain_f32": (kernel_fn(flash_attention_ref, "float32"), 5),
        "sdpa_f32": (sdpa_fn("float32"), 20),
    }
    times = time_turns(torch, timed)
    bounds = {dt: attention_bound(*slice_in[dt][0], True, 0) for dt in slice_in}
    for dt, route_ms, label in (("bfloat16", "wgmma", "wgmma"),
                                ("bfloat16", "mma_bf16", "mma (bf16, a yardstick)"),
                                ("float32", "mma", "mma")):
        bound_ms, bound_by, flops, nbytes, terms = bounds[dt]
        short = "bf16" if dt == "bfloat16" else "f32"
        print(f"  slice shape {SLICE_SHAPE} {dt} causal, {label}: kernel "
              f"{times[route_ms]:.4f} ms, plain {times['plain_' + short]:.4f} ms, sdpa "
              f"{times['sdpa_' + short]:.4f} ms; bound {bound_ms * 1e3:.2f} us by "
              f"{bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB: "
              f"{bound_terms(terms)}); kernel at {flops / times[route_ms] / 1e9:.2f} "
              f"TFLOP/s, {times[route_ms] / bound_ms:.2f}x its bound")
    print(f"  wgmma route: {times['mma_bf16'] / times['wgmma']:.2f}x faster than the "
          f"mma kernel on the same bf16 inputs, {times['wgmma'] / times['sdpa_bf16']:.2f}x "
          f"SDPA's time, {times['wgmma'] / bounds['bfloat16'][0]:.2f}x its bound")
    print(f"  mma route, f32: {times['sdpa_f32'] / times['mma']:.2f}x faster than SDPA f32")
    # peak memory while serving counts the model alone
    del timed, slice_in

    # the wgmma route at head_dim 128 (chatglm3, internlm2, llava), the same
    # B, S, H, KV, and the mma route in bf16 at the yardstick shapes, beside
    # SDPA: printed, not in the kernels line
    for label, shape, route_fn in (
            ("head_dim 128, wgmma", (*SLICE_SHAPE[:4], 128), ops.flash_attention),
            *[(f"{name}, mma", shape, fa.flash_attention_mma)
              for name, shape in YARDSTICKS.items()]):
        (q, k, v), (qt, kt, vt) = attention_inputs(torch, gen, dev, shape, "bfloat16")
        pair = {"kernel": lambda: route_fn(q, k, v, causal=True),
                "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)}
        torch.testing.assert_close(pair["kernel"]().float(),
                                   pair["sdpa"]().transpose(1, 2).float(),
                                   rtol=BF16_TOL, atol=BF16_TOL)
        got = time_pair(torch, pair, 100)
        bound_ms, bound_by, flops, nbytes, terms = attention_bound(q, k, v, True, 0)
        print(f"  {label}: {shape} bfloat16 causal: kernel {got['kernel']:.4f} ms, sdpa "
              f"{got['sdpa']:.4f} ms ({got['kernel'] / got['sdpa']:.2f}x); bound "
              f"{bound_ms * 1e3:.2f} us by {bound_by} ({bound_terms(terms)}); kernel at "
              f"{flops / got['kernel'] / 1e9:.2f} TFLOP/s, "
              f"{got['kernel'] / bound_ms:.2f}x its bound")
        del q, k, v, qt, kt, vt, pair
    head_dims = padded_head_dim_times(torch, gen, dev, fa, ops, smi_line)

    # the wide route (head_dim above 256) beside its plain version and SDPA:
    # f32 at WIDE_SHAPE goes to the kernels line, the rest is printed
    wide = {}
    for shape in WIDE_SHAPES:
        for dt in ("float32", "bfloat16"):
            (q, k, v), (qt, kt, vt) = attention_inputs(torch, gen, dev, shape, dt)
            fns = {"kernel": lambda: fa.flash_attention_wide(q, k, v, causal=True),
                   "plain": lambda: flash_attention_ref(q, k, v, causal=True),
                   "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True)}
            got = fns["kernel"]()
            err, ok = compare(got, fns["plain"](), F32_TOL if dt == "float32" else BF16_TOL)
            if not ok:
                fail(f"the wide kernel disagrees with its plain version at {shape} {dt}")
            torch.testing.assert_close(got.float(), fns["sdpa"]().transpose(1, 2).float(),
                                       rtol=BF16_TOL, atol=BF16_TOL)
            got = time_pair(torch, fns, 20)
            bound = attention_bound(q, k, v, True, 0)
            print(f"  wide route: {shape} {dt} causal: kernel {got['kernel']:.4f} ms, plain "
                  f"{got['plain']:.4f} ms, sdpa {got['sdpa']:.4f} ms "
                  f"({got['kernel'] / got['sdpa']:.2f}x SDPA); max_abs_err {err:.3g}; bound "
                  f"{bound[0] * 1e3:.2f} us by {bound[1]} ({bound_terms(bound[4])}); kernel "
                  f"at {bound[2] / got['kernel'] / 1e9:.2f} TFLOP/s, "
                  f"{got['kernel'] / bound[0]:.2f}x its bound")
            if shape == WIDE_SHAPE:
                wide[dt] = dict(got, err=err, bound=bound)
            del q, k, v, qt, kt, vt, fns

    # 4. the SSD kernel against its plain version ---------------------------
    phase("SSD kernel checks")
    ssd_err = 0.0
    for B, S, H, P, N, chunk, slow in SSD_CASES:
        xh, dt, A, Bm, Cm = ssd_inputs(torch, gen, dev, B, S, H, P, N, slow)
        got, got_state = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk, return_state=True)
        torch.cuda.synchronize()
        want, want_state = ssd_scan_ref(xh, dt, A, Bm, Cm, return_state=True)
        err, ok = compare(got, want, SSD_TOL)
        err_state, ok_state = compare(got_state, want_state, SSD_TOL)
        print(f"  B={B} S={S} H={H} P={P} N={N} chunk={chunk}"
              f"{' slow decay' if slow else ''}: max_abs_err y={err:.3g} "
              f"state={err_state:.3g} (rtol = atol = {SSD_TOL}) "
              f"{'ok' if ok and ok_state else 'FAIL'}")
        if not (ok and ok_state and torch.isfinite(got).all()):
            fail(f"SSD kernel disagrees with its plain version at "
                 f"{(B, S, H, P, N, chunk, slow)}")
        if (B, S, H, P, N, chunk) == SSD_SLICE:  # both decays
            ssd_err = max(ssd_err, err, err_state)

    B, S, H, P, N, chunk = SSD_SLICE
    xh, dt, A, Bm, Cm = ssd_inputs(torch, gen, dev, B, S, H, P, N)
    ssd_fn = lambda: ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk,  # noqa: E731
                                  return_state=True)
    ssd_plain_fn = lambda: ssd_scan_ref(xh, dt, A, Bm, Cm,  # noqa: E731
                                        return_state=True)
    ssd_times = {"ms": [], "plain_ms": []}
    for _ in range(3):  # in turns
        ssd_times["ms"].append(time_ms(torch, ssd_fn, 10))
        ssd_times["plain_ms"].append(time_ms(torch, ssd_plain_fn, 2))
    ssd_times = {key: statistics.median(vals) for key, vals in ssd_times.items()}
    ssd_bound_ms, ssd_bound_by, flops, nbytes, terms = ssd_bound(xh, Bm, chunk)
    print(f"  slice shape {SSD_SLICE} f32 with final state: kernel "
          f"{ssd_times['ms']:.4f} ms, plain {ssd_times['plain_ms']:.4f} ms; "
          f"bound {ssd_bound_ms * 1e3:.2f} us by {ssd_bound_by}: operations "
          f"{flops / 1e9:.2f} GFLOP take {terms['f32_ms'] * 1e3:.2f} us on the f32 cores and "
          f"{terms['3xtf32_ms'] * 1e3:.2f} us as 3xTF32 on the tensor cores, bytes "
          f"{nbytes / 1e6:.1f} MB take {terms['bytes_ms'] * 1e3:.2f} us; kernel at "
          f"{flops / ssd_times['ms'] / 1e9:.2f} TFLOP/s of counted operations, "
          f"{ssd_times['ms'] / ssd_bound_ms:.2f}x its bound")
    if ssd_times["ms"] < ssd_bound_ms:
        fail(f"the SSD kernel reads {ssd_times['ms']:.4f} ms, below its "
             f"{ssd_bound_ms:.4f} ms bound: the timing or the bound is wrong")
    # zamba2-7b's shape (112 heads, state 64): printed, not in the kernels line
    B, S, H, P, N, chunk = ZAMBA2_SSD
    zx = ssd_inputs(torch, gen, dev, B, S, H, P, N)
    got = {"ms": [], "plain_ms": []}
    for _ in range(3):  # in turns
        got["ms"].append(time_ms(torch, lambda: ops.ssd_scan(*zx, chunk=chunk,
                                                             return_state=True), 10))
        got["plain_ms"].append(time_ms(torch, lambda: ssd_scan_ref(*zx, return_state=True), 1))
    got = {key: statistics.median(vals) for key, vals in got.items()}
    zb = ssd_bound(zx[0], zx[3], chunk)
    print(f"  zamba2-7b's shape {ZAMBA2_SSD} f32 with final state: kernel {got['ms']:.4f} ms, "
          f"plain {got['plain_ms']:.4f} ms; bound {zb[0] * 1e3:.2f} us by {zb[1]} "
          f"({bound_terms(zb[4])}); kernel {got['ms'] / zb[0]:.2f}x its bound")
    del zx

    # 5. the backward kernel against its plain version -----------------------
    bwd = backward_phase(torch, dev, gen, fa, ops, flash_attention_ref, flash_attention_bwd_ref)
    ssd_bwd = ssd_bwd_phase(torch, dev, gen, ops, ssd, ssd_scan_bwd_ref)
    encdec_vlm_kernel_phase(torch, dev, gen, fa, ops, flash_attention_ref,
                            flash_attention_bwd_ref)

    # 6. and 7. serve each model through its kernels ------------------------
    layers = get_config("llama3.2-1b").num_layers
    flash, flash32 = check_serving(
        "llama3.2-1b", flash_want(fa, wgmma=layers), dict(attention=flash_attention_ref),
        LOGITS_REL_TOL, f32_tol=LLAMA_F32_REL_TOL, want_f32=flash_want(fa, mma=layers))
    ssd_launches, _ = check_serving(
        "mamba2-370m", {ssd.ssd_scan: get_config("mamba2-370m").num_layers},
        dict(ssd_scan=ssd_scan_ref), SSM_BF16_REL_TOL, f32_tol=SSM_F32_REL_TOL,
        fault=scan_fault())
    serving_phases(fa, ssd, flash_attention_ref, ssd_scan_ref)
    moe_serving_phases(fa, flash_attention_ref)
    encdec_vlm_serving_phases(fa, flash_attention_ref)
    family_training_phase(torch, dev, fa, ssd, MOE_TRAIN_ARCH)
    family_training_phase(torch, dev, fa, ssd, "whisper-medium", seq=WHISPER_TEXT)
    llava_layers, why = llava_train_layers(get_config("llava-next-34b"),
                                           torch.cuda.mem_get_info(dev)[1])
    family_training_phase(torch, dev, fa, ssd, "llava-next-34b", layers=llava_layers,
                          seq=SERVE_PROMPT, plain_rows=1, no_f32=LLAVA_NO_F32, why=why)
    compression_phase(torch, dev)

    # 8. train full-width llama3.2-1b, mamba2-370m and zamba2-7b at 13
    # layers; 9. the data-parallel step -------------------------------------
    train_launches = training_phase(torch, dev, get_config, LM, fa, flash_attention_ref,
                                    flash_attention_bwd_ref)
    ssm_launches = family_training_phase(torch, dev, fa, ssd, "mamba2-370m")
    # zamba2's shared attention block (hd 112) runs the backward's mma route
    hybrid_launches = family_training_phase(torch, dev, fa, ssd, "zamba2-7b",
                                            layers=ZAMBA2_TRAIN_LAYERS)
    dp_phase(torch, dev, fa)

    # 10. checkpoint/resume and the elastic recovery -------------------------
    checkpoint_phase(torch, dev, fa, smi_line)

    # 11. the collective path; 12. repaired plans and limited switch buffers -
    D = collective_phase(torch, dev, get_config, LM)
    plan_repair_phase(torch, dev, D)
    switch_buffers_phase(torch, dev, smi_line)

    # 13. the planner examples; 14. serve_batch's stepped serving ----------
    examples_phase(torch, dev)
    serve_batch_phase(torch, dev, fa)

    # 15. the sharding policy: LM(policy=) and pad_heads ----------------------
    per_rank = sharding_policy_phase(torch, dev, fa, ops, ssd, smi_line)

    # 16. launch/steps.py: stand-ins, the train, prefill and decode kinds ---
    bundle_launches = steps_phase(torch, dev, fa, smi_line)

    # 17. launch/train.py and serve.py under the mesh and policy ------------
    launch_launches = launch_phase(torch, dev, fa, smi_line)

    # 18. launch/dryrun.py: the operators, the prediction, the pod cells ------
    dryrun_ops = dryrun_phase(torch, dev, fa, ops, ssd, smi_line)

    # 19. per-kernel numbers ------------------------------------------------
    total_s = time.perf_counter() - t_start
    print(f"chip_smoke: {total_s:.1f} s in all, {total_s - build_s:.1f} s without the build")
    ends = [t for _, t in PHASE_STARTS[1:]] + [time.perf_counter()]
    print("chip_smoke: s by phase: " + ", ".join(
        f"{name} {end - t:.1f}" for (name, t), end in zip(PHASE_STARTS, ends)))
    flash_source = "src/repro_torch/kernels/csrc/"
    print(json.dumps({"kernels": [{
        "name": "flash_attention_wgmma",
        "route": "cuda",
        "source": flash_source + "flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": flash[fa.flash_attention_wgmma],
        "max_abs_err": slice_err["bfloat16"],
        "ms": times["wgmma"],
        "plain_ms": times["plain_bf16"],
        "bound_ms": bounds["bfloat16"][0],
        "bound_by": bounds["bfloat16"][1],
        "library_ms": times["sdpa_bf16"],
        "head_dims": head_dims,
        "tp_shapes": per_rank["flash_attention_wgmma"],
        "steps_launches": bundle_launches["wgmma"],
        "launch_launches": launch_launches["wgmma"],
        "op_host_us": dryrun_ops["flash_attention"]["op_host_us"],
        "wrapper_host_us": dryrun_ops["flash_attention"]["wrapper_host_us"],
    }, {
        "name": "flash_attention_mma",
        "route": "cuda",
        "source": flash_source + "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": flash32[fa.flash_attention_mma],
        "max_abs_err": slice_err["float32"],
        "ms": times["mma"],
        "plain_ms": times["plain_f32"],
        "bound_ms": bounds["float32"][0],
        "bound_by": bounds["float32"][1],
        "library_ms": times["sdpa_f32"],
    }, {
        "name": "flash_attention_wide",
        "route": "cuda",
        "source": flash_source + "flash_attention_wide.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": flash32[fa.flash_attention_wide],
        "max_abs_err": wide["float32"]["err"],
        "ms": wide["float32"]["kernel"],
        "plain_ms": wide["float32"]["plain"],
        "bound_ms": wide["float32"]["bound"][0],
        "bound_by": wide["float32"]["bound"][1],
        "library_ms": wide["float32"]["sdpa"],
    }, {
        "name": "flash_attention_bwd_wgmma",
        "route": "cuda",
        "source": flash_source + "flash_attention_bwd_wgmma.cu",
        "replaces": "src/repro/models/attention.py:227",
        "launches": train_launches["flash_attention_bwd_wgmma"],
        "max_abs_err": bwd["wgmma"]["err"],
        "ms": bwd["wgmma"]["ms"],
        "plain_ms": bwd["wgmma"]["plain_ms"],
        "bound_ms": bwd["wgmma"]["bound"][0],
        "bound_by": bwd["wgmma"]["bound"][1],
        "library_ms": bwd["wgmma"]["library_ms"],
        "library_device_ms": bwd["wgmma"]["library_device_ms"],
        "passes_ms": bwd["wgmma"]["passes"],
        "host_us": bwd["wgmma"]["host_us"],
        "tp_shapes": per_rank["flash_attention_bwd"],
        "steps_launches": bundle_launches["bwd"],
        "launch_launches": launch_launches["bwd"],
        "op_host_us": dryrun_ops["flash_attention_bwd"]["op_host_us"],
        "wrapper_host_us": dryrun_ops["flash_attention_bwd"]["wrapper_host_us"],
    }, {
        # timed at llama's training shape beside the wgmma route; its
        # launches are zamba2-7b's training steps (the shared block at hd 112)
        "name": "flash_attention_bwd_mma",
        "route": "cuda",
        "source": flash_source + "flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:227",
        "launches": hybrid_launches["flash_attention_bwd_mma"],
        "max_abs_err": bwd["mma"]["err"],
        "ms": bwd["mma"]["ms"],
        "plain_ms": bwd["mma"]["plain_ms"],
        "bound_ms": bwd["mma"]["bound"][0],
        "bound_by": bwd["mma"]["bound"][1],
        "library_ms": bwd["mma"]["library_ms"],
        "library_device_ms": bwd["mma"]["library_device_ms"],
        "passes_ms": bwd["mma"]["passes"],
        "host_us": bwd["mma"]["host_us"],
        "zamba2_shape": ZAMBA2_BWD,
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:26",
        "launches": ssd_launches[ssd.ssd_scan],
        "max_abs_err": ssd_err,
        "ms": ssd_times["ms"],
        "plain_ms": ssd_times["plain_ms"],
        "bound_ms": ssd_bound_ms,
        "bound_by": ssd_bound_by,
        "library_ms": None,
        "tp_shapes": per_rank["ssd_scan"],
        "op_host_us": dryrun_ops["ssd_scan"]["op_host_us"],
        "wrapper_host_us": dryrun_ops["ssd_scan"]["wrapper_host_us"],
    }, {
        "name": "ssd_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:61",
        "launches": ssm_launches["ssd_scan_bwd"],
        "max_abs_err": ssd_bwd["err"],
        "ms": ssd_bwd["ms"],
        "plain_ms": ssd_bwd["plain_ms"],
        "bound_ms": ssd_bwd["bound"][0],
        "bound_by": ssd_bwd["bound"][1],
        "library_ms": None,
        "tp_shapes": per_rank["ssd_scan_bwd"],
        "op_host_us": dryrun_ops["ssd_scan_bwd"]["op_host_us"],
        "wrapper_host_us": dryrun_ops["ssd_scan_bwd"]["wrapper_host_us"],
    }]}))
    # 20. result -------------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
