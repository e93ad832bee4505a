#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. the card: nvidia-smi's name and power limit, torch's device name; TF32 off;
2. build the CUDA kernels from the sources in this checkout (nvcc, sm_90a);
3. hold the three flash-attention routes (the wgmma kernel for bf16 at
   head_dim 64 / 128, the mma kernel for f32 and every other head_dim up to
   256, the wide kernel above 256) against their plain PyTorch version on
   the card at the test shapes
   (head_dim 112 and 120 included), strided views of a fused projection,
   the serving shape and the served shapes of chatglm3-6b (16 query heads
   a KV head) and zamba2-7b (MHA at hd 112), each call counted on the
   route that the table names;
   then time both at the serving shape beside the plain version, the bound
   and, as a yardstick the port never calls,
   ``torch.nn.functional.scaled_dot_product_attention``; and the mma route
   in bf16 at the training slice's shape and at head_dim 120 and 112 beside
   SDPA (printed only); the wide route at head_dim 512 and 1024 beside its
   plain version and SDPA;
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
   after every 6 of them, 13 calls of the mma route and 81 of the SSD
   kernel a prefill; plain attention and plain scan together as the
   comparison, the same planted fault), chatglm3-6b and internlm2-20b
   (the wgmma route at hd 128) and h2o-danube-3-4b (the mma route at hd
   120, and a 6144-token prompt on which its 4096-token window binds, with
   the window left out as a planted fault), each at full width and depth
   in bf16 and again in f32 (internlm2-20b's f32 at 24 of its 48 layers:
   all 48 do not fit the card in f32);
8. train full-width llama3.2-1b on the card (bf16 compute, f32 master
   params and AdamW state, 4 x 1024 tokens a step): the first step's loss
   and gradient norm beside the same step through the plain attention
   forward and backward, then three timed steps with each flash kernel's
   launches counted over them; then the same for full-width mamba2-370m
   and for zamba2-7b at full width and 13 of its 81 layers (the SSD scan
   and its backward, and zamba2's shared attention block, through their
   kernels; the plain scan, scan backward and attention as the
   comparison), each with its launches counted exactly, one traced step,
   and the first step repeated in f32 with every SSM gradient leaf held to
   the plain one;
9. the data-parallel step of train_lm's 100m model with 8 ranks stacked on
   the card, PCCL beside the built-in reduction: the ``PCCL_CONFORMANCE``
   line, every rank's params equal bit for bit after each step;
10. the collective path: the executor's selftest on the card; the four
   fig_exec routes (8 ranks, 4096 f32 a shard) with their round and send
   counts, bit for bit against the port's numpy round interpreter and
   within 1e-5 of a plain sum; and the all-reduce of mamba2-370m's f32
   gradient vector over a bidirectional ring of 8 ranks held in one tensor
   on the card, bit for bit on a column sample, against ``x.sum(0)``, with
   exact zeros off a subgroup of 5, timed beside ``x.sum(0)``;
11. plan repair, on the same stacked backend: BENCH_synthesis.json's
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
   a shard;
12. print one JSON line of per-kernel numbers;
13. print the result line ``{"ok": true, "device": {...}}`` last.

Imports nothing of jax or of the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
    # head dims only the mma route takes: zamba2-7b's 112, h2o-danube's 120
    *[case for hd in (112, 120) for dt in ("float32", "bfloat16") for case in (
        (1, 1000, 1000, 4, 2, hd, dt, dict(causal=True)),             # ragged, GQA
        (1, 256, 256, 4, 4, hd, dt, dict(causal=True, window=96)),
        (1, 128, 128, 2, 2, hd, dt, dict(causal=True, softcap=20.0)),
        (1, 64, 8, 2, 2, hd, dt, dict(causal=True, window=4)),         # empty rows
    )],
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
    # head (wgmma in bf16, mma in f32), zamba2-7b's MHA at hd 112 (mma)
    (4, 1024, 1024, 32, 2, 128, "bfloat16", dict(causal=True)),
    (4, 1024, 1024, 32, 2, 128, "float32", dict(causal=True)),
    (4, 1024, 1024, 32, 32, 112, "bfloat16", dict(causal=True)),
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
]
# the mma route in bf16, timed beside SDPA (causal): B, S, H, KV, hd
YARDSTICKS = {
    "the 10m training model": (8, 256, 8, 4, 32),
    "h2o-danube-3-4b's head_dim": (SERVE_BATCH, SERVE_PROMPT, 32, 8, 120),
    "zamba2-7b's head_dim": (SERVE_BATCH, SERVE_PROMPT, 32, 32, 112),
}

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
# the data-parallel step: train_lm's model, ranks stacked on the card,
# steps, global batch and sequence; the limits of the conformance line
# that tests/test_exec_conformance.py holds examples/train_lm.py to
DP_MODEL, DP_RANKS, DP_STEPS, DP_BATCH, DP_SEQ = "100m", 8, 3, 8, 256
DP_LOSS_TOL, DP_PARAM_TOL = 1e-4, 1e-3

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
# tests/test_repair_property.py's check_repair_seed(60973): the reference's
# repair of a planned reduce_scatter over three_level(2, 2, 2) stops on a
# bare AssertionError under this event
SEED_60973_EVENT = {"failed_links": [11, 18, 20], "failed_npus": [5]}


# ptxas -v lines: the entry a block of lines is about, its registers and spills
PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PTXAS_REGS = re.compile(r"Used (\d+) registers")
BWD_SYMBOL = re.compile(r"flash_bwd_(lse|dkdv|dq)_kernelI(f|13__nv_bfloat16)Li(\d+)E")


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


def bwd_ptxas(log: str) -> list[str]:
    """One line per instance of the backward's passes in nvcc's ``-Xptxas
    -v`` output: pass, type, padded head_dim, registers, spill bytes."""
    rows, entry, spill = [], None, ("?", "?")
    for line in log.splitlines():
        if m := PTXAS_ENTRY.search(line):
            entry, spill = BWD_SYMBOL.search(m[1]), ("?", "?")
        elif m := PTXAS_SPILL.search(line):
            spill = (m[1], m[2])
        elif (m := PTXAS_REGS.search(line)) and entry:
            dtype = "f32" if entry[2] == "f" else "bf16"
            rows.append(f"flash_bwd_{entry[1]}_kernel {dtype} hd {entry[3]}: {m[1]} registers, "
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


def visible_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible: the work attention must do."""
    total = 0
    for s in range(S):
        hi = min(T - 1, s) if causal else T - 1
        lo = max(0, s - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


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
    B, S, H, hd = q.shape
    T = k.shape[1]
    flops = 4 * B * H * hd * visible_pairs(S, T, causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return roofline(flops, nbytes, q.element_size() == 4)


def attention_bwd_bound(q, k, causal, window):
    """The backward's bound (``roofline``): its five products (dV = P^T dO,
    dP = dO V^T, S = Q K^T recomputed, dQ = dS K, dK = dS^T Q), 2.5x the
    forward's, over the visible pairs; q, k, v, o and dO read once, dq, dk
    and dv written once."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    flops = 2.5 * 4 * B * H * hd * visible_pairs(S, T, causal, window)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    return roofline(flops, nbytes, q.element_size() == 4)


def bound_terms(terms: dict) -> str:
    return ", ".join(f"{key.removesuffix('_ms')} {ms * 1e3:.2f} us" for key, ms in terms.items())


def attention_inputs(torch, gen, dev, shape, dt):
    """q [B, S, H, hd], k and v [B, S, KV, hd] of type ``dt``, and their
    [B, heads, S, hd] copies for SDPA."""
    B, S, H, KV, hd = shape
    qkv = [torch.randn(s, generator=gen, device=dev).to(getattr(torch, dt))
           for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    return qkv, [x.transpose(1, 2).contiguous() for x in qkv]


def ssd_bound(xh, Bm, chunk: int):
    """(bound_ms, bound_by, flops, bytes, terms) of the SSD scan as prefill
    calls it (with the final state). The operations: C.B^T over the causal
    pairs once per (b, chunk), since B and C, and so the scores, are shared
    by all heads; then per (b, h, chunk) the scores' product with x*dt,
    C.state^T and the state update. They take the faster of two routes that
    keep f32 accuracy: the f32 CUDA cores, or the TF32 tensor cores at three
    products each (3xTF32: hi*hi' + hi*lo' + lo*hi'; one TF32 product misses
    the scan's 1e-4). Bytes over HBM bandwidth: each input read once, y and
    the final state written once. ``terms`` holds the three times in ms."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    flops = 0
    for t0 in range(0, S, chunk):
        q = min(chunk, S - t0)
        pairs = q * (q + 1) // 2
        flops += B * (pairs * N * 2 + H * (pairs * P * 2 + 2 * q * N * P * 2))
    nbytes = (2 * xh.numel() + B * S * H + H + 2 * Bm.numel() + B * H * P * N) * 4
    terms = {"f32_ms": flops / PEAK_FLOPS["float32"] * 1e3,
             "3xtf32_ms": 3 * flops / PEAK_FLOPS["tf32"] * 1e3,
             "bytes_ms": nbytes / PEAK_BYTES * 1e3}
    t_ops = min(terms["f32_ms"], terms["3xtf32_ms"])
    return (max(t_ops, terms["bytes_ms"]),
            "operations" if t_ops >= terms["bytes_ms"] else "bytes", flops, nbytes, terms)


def ssd_bwd_bound(xh, Bm, chunk: int):
    """(bound_ms, bound_by, flops, bytes, terms) of the SSD backward, as
    ``ssd_bound``. The operations: once per (b, chunk), over the causal
    pairs, C.B^T and the intra-chunk parts of dB and dC, Wsum^T C and Wsum
    B, with Wsum = sum_h W the heads' W summed (H adds a pair), since every
    head shares B and C; per (b, h, chunk) dy.x^T and (C.B^T o L)^T dy over
    the causal pairs, and the products of q x P x N that the function needs:
    the chunk's state (the forward's, recomputed), B carry^T and x carry in
    every chunk but the last (the last chunk's state is read by nothing and
    its carry is 0), its reverse state dy^T C and dy h_in in every chunk but
    the first (its entering state is 0). Bytes: xh, dt, A, Bm, Cm and dy
    read once; dxh, ddt, dA, dBm and dCm written once."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    flops = 0
    for c in range(nc):
        q = min(chunk, S - c * chunk)
        pairs = q * (q + 1) // 2
        products = 3 * (c < nc - 1) + 2 * (c > 0)
        flops += B * (3 * pairs * N * 2 + H * pairs
                      + H * (2 * pairs * P * 2 + products * q * P * N * 2))
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


def time_pair(torch, fns: dict, reps: int) -> dict:
    """Median ms of each function over three rounds in turns."""
    got = {name: [] for name in fns}
    for _ in range(3):
        for name, fn in fns.items():
            got[name].append(time_ms(torch, fn, reps))
    return {name: statistics.median(vals) for name, vals in got.items()}


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


def flash_counters(fa) -> tuple:
    """Every flash kernel's launch counter: the routed forward's total, each
    forward route's, and the backward's."""
    return (fa.flash_attention, fa.flash_attention_wgmma, fa.flash_attention_mma,
            fa.flash_attention_wide, fa.flash_attention_bwd)


def backward_phase(torch, dev, gen, fa, ops, flash_attention_ref,
                   flash_attention_bwd_ref) -> dict:
    """The backward kernel against its plain version at ``BWD_CASES``, then
    timed at the training shape beside the plain version, its bound and
    SDPA's backward. Returns the kernels-line numbers."""
    from repro_torch.launch import trace

    phase("flash backward kernel checks")
    got_err = None
    for B, S, T, H, KV, hd, dt, kw in BWD_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(dtype)
        do = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
        o = flash_attention_ref(q, k, v, **kw)
        before = fa.flash_attention_bwd.launches
        got = ops.flash_attention_bwd(q, k, v, o, do, **kw)
        torch.cuda.synchronize()
        if fa.flash_attention_bwd.launches != before + 1:
            fail("the backward wrapper did not count its launch")
        want = flash_attention_bwd_ref(q, k, v, o, do, **kw)
        tol = F32_TOL if dt == "float32" else BF16_TOL
        checked = [compare(g, w, tol) for g, w in zip(got, want)]
        ok = all(c[1] for c in checked) and all(bool(torch.isfinite(g).all()) for g in got)
        print(f"  B={B} S={S} T={T} H={H} KV={KV} hd={hd} {dt} {kw}: max_abs_err dq/dk/dv "
              f"{' / '.join(f'{c[0]:.3g}' for c in checked)} (tol {tol}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the backward kernel disagrees with its plain version at "
                 f"{(B, S, T, H, KV, hd, dt, kw)}")
        if (B, S, H, KV, hd) == TRAIN_SHAPE and dt == "bfloat16":
            got_err = max(c[0] for c in checked)

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
    print(f"  training shape {TRAIN_SHAPE} bfloat16 causal: two calls bit-equal (dq, dk, dv)")
    del first
    fns = {"kernel": (lambda: ops.flash_attention_bwd(q, k, v, o, do, causal=True), 20),
           "plain": (lambda: flash_attention_bwd_ref(q, k, v, o, do, causal=True), 3),
           "sdpa_bwd": (lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                    retain_graph=True), 20)}
    times = {name: [] for name in fns}
    for _ in range(3):  # in turns
        for name, (fn, reps) in fns.items():
            times[name].append(time_ms(torch, fn, reps))
    times = {name: statistics.median(vals) for name, vals in times.items()}
    bound = attention_bwd_bound(q, k, True, 0)
    print(f"  training shape {TRAIN_SHAPE} bfloat16 causal: kernel {times['kernel']:.4f} ms, "
          f"plain {times['plain']:.4f} ms, sdpa backward {times['sdpa_bwd']:.4f} ms "
          f"({times['kernel'] / times['sdpa_bwd']:.2f}x); bound {bound[0] * 1e3:.2f} us by "
          f"{bound[1]} ({bound[2] / 1e9:.2f} GFLOP, {bound[3] / 1e6:.1f} MB: "
          f"{bound_terms(bound[4])}); kernel at {bound[2] / times['kernel'] / 1e9:.2f} "
          f"TFLOP/s of the backward's products, {times['kernel'] / bound[0]:.2f}x its bound")
    # device time of each pass, from the profiler's kernel records
    calls, run = 5, fns["kernel"][0]
    by_name = trace.traced(lambda: [run() for _ in range(calls)], dev)["by_name"]
    passes = {m[1]: us / calls / 1e3 for name, us in by_name.items()
              if (m := re.search(r"flash_bwd_(lse|dkdv|dq)_kernel", name))}
    print(f"  training shape bfloat16, device time by pass (profiler, {calls} calls): " +
          ", ".join(f"{name} {ms:.4f} ms" for name, ms in passes.items()))
    del q, k, v, o, do, qt, kt, vt, ot, dot, fns, run

    # the same in f32 (the mma forward, 3xTF32 in the backward): printed, not
    # in the kernels line (the training path runs bf16)
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
    print(f"  training shape {TRAIN_SHAPE} float32 causal: kernel {f32['kernel']:.4f} ms, sdpa "
          f"backward {f32['sdpa_bwd']:.4f} ms ({f32['kernel'] / f32['sdpa_bwd']:.2f}x; max "
          f"abs diff {diff:.3g}); bound {bound32[0] * 1e3:.2f} us by {bound32[1]} "
          f"({bound_terms(bound32[4])}); kernel {f32['kernel'] / bound32[0]:.2f}x its bound")
    return dict(err=got_err, ms=times["kernel"], plain_ms=times["plain"],
                library_ms=times["sdpa_bwd"], bound=bound)


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
            "flash_attention_bwd": L * TRAIN_STEPS}
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
        times = {name: [] for name in fns}
        for _ in range(3):  # in turns
            for name, (fn, reps) in fns.items():
                times[name].append(time_ms(torch, fn, reps))
        times = {name: statistics.median(vals) for name, vals in times.items()}
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


def ssm_training_phase(torch, dev, fa, ssd, arch: str, *, layers: int | None = None,
                       f32_layers: int | None = None) -> dict:
    """Training steps of ``arch`` (the ssm or hybrid family) on the card at
    full width, ``layers`` of its layers if given: bf16 compute, f32 master
    params and AdamW state, remat per block, 4 x 1024 tokens a step. The
    first step (the warm-up) beside the same step through the chunked plain
    scan, its autograd backward and the plain attention; the same first step in f32 (at
    ``f32_layers`` if given), where every SSM gradient leaf is held to
    ``SSM_GRAD_REL_TOL``; then ``TRAIN_STEPS`` timed steps with every
    kernel's launches counted exactly, and one traced step. Returns the
    launches."""
    from repro_torch.bridge import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import _batch_for_step
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
    B, S = TRAIN_SHAPE[:2]
    # the comparison steps run the chunked plain scan (the token-by-token
    # recurrence holds the kernel in the kernel phases), without remat: the
    # same values, and each plain scan once a block instead of twice
    plain_kw = dict(attention=flash_attention_ref, attention_bwd=flash_attention_bwd_ref,
                    ssd_scan=ssd_chunked_ref, ssd_scan_bwd=ssd_scan_bwd_ref)
    batches = [{key: torch.from_numpy(val).to(dev, torch.int64) for key, val in
                _batch_for_step(DATA_SEED, step, B, S, cfg.vocab_size).items()}
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
        del q, k, v, o, do, got

    lm, params = model(cfg)
    print(f"{cfg.name}: {count_params(params)} params (f32 master weights), compute "
          f"{cfg.dtype}, {cfg.num_layers} of {full.num_layers} layers, d_model {cfg.d_model}, "
          f"batch {B} x {S} tokens, remat per block")
    plain_loss, grads = loss_and_grads(LM(cfg, device=dev, **plain_kw), params,
                                       batches[0])
    plain_loss, plain_gnorm = float(plain_loss), float(global_norm(grads))
    del grads
    opt = adamw_init(params)
    lr = cosine_schedule(3e-4, warmup=20, total=100)
    loss, grads = loss_and_grads(lm, params, batches[0])
    loss, gnorm = float(loss), float(global_norm(grads))
    adamw_update(params, grads, opt, lr=lr)
    del grads
    rel_loss = abs(loss - plain_loss) / abs(plain_loss)
    print(f"  first step, kernels vs plain scan, scan backward and attention: loss {loss:.6f} vs "
          f"{plain_loss:.6f} (rel {rel_loss:.3g}, tol {TRAIN_LOSS_REL_TOL}); grad norm "
          f"{gnorm:.6f} vs {plain_gnorm:.6f} (rel {abs(gnorm - plain_gnorm) / plain_gnorm:.3g})")
    if not (rel_loss <= TRAIN_LOSS_REL_TOL and finite(loss, gnorm)):
        fail(f"the first {arch} training step's loss disagrees with the plain kernels'")

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
    groups = L // cfg.hybrid_attn_period if cfg.family == "hybrid" else 0
    want = {"ssd_scan": 2 * L, "ssd_scan_bwd": L, "flash_attention": 2 * groups,
            "flash_attention_wgmma": 0, "flash_attention_mma": 2 * groups,
            "flash_attention_wide": 0, "flash_attention_bwd": groups}
    want = {name: n * TRAIN_STEPS for name, n in want.items()}
    if launches != want:
        fail(f"launches over {TRAIN_STEPS} {arch} training steps {launches}, want {want} (the "
             f"scan and the attention once a block and again in remat's recompute, each "
             f"backward once)")
    if not finite(*losses):
        fail(f"a {arch} training step's loss is not finite")

    def one_step():
        _, grads = loss_and_grads(lm, params, batches[-1])
        adamw_update(params, grads, opt, lr=lr)

    trace.print_phase(f"{label}, one step traced", trace.traced(one_step, dev), 1, 8)
    del lm, params, opt
    torch.cuda.empty_cache()

    # the first step again in f32, where rounding does not hide a fault
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=f32_layers or L)
    if cfg32.num_layers != L:
        print(f"  f32 repeat at {cfg32.num_layers} of the {L} layers")
    lm32, params32 = model(cfg32)
    loss32, g_kernel = loss_and_grads(lm32, params32, batches[0])
    plain32, g_plain = loss_and_grads(LM(cfg32, device=dev, **plain_kw), params32,
                                      batches[0])
    rel32 = abs(float(loss32) - float(plain32)) / abs(float(plain32))
    rels = {".".join(path): rel_l2(gk, gp) for (path, gk), (_, gp) in
            zip(named_leaves(g_kernel), named_leaves(g_plain)) if "ssd" in path}
    worst = max(rels, key=rels.get)
    print(f"  f32 first step, kernels vs plain: loss rel {rel32:.3g}; SSM gradient leaves, "
          f"rel-L2 (tol {SSM_GRAD_REL_TOL}): " +
          ", ".join(f"{path.split('.')[-1]} {rel:.3g}" for path, rel in rels.items()
                    if path.startswith("layers.")) + f"; worst {worst} {rels[worst]:.3g}")
    if not (rel32 <= TRAIN_LOSS_REL_TOL and rels[worst] <= SSM_GRAD_REL_TOL):
        fail(f"the f32 {arch} training step's loss or an SSM gradient leaf disagrees with "
             f"the plain kernels'")
    del lm32, params32, g_kernel, g_plain
    torch.cuda.empty_cache()
    print(f"{label}: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


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


def flash_want(fa, wgmma: int = 0, mma: int = 0) -> dict:
    """Launches a served prefill must count on each forward flash route."""
    return {fa.flash_attention: wgmma + mma, fa.flash_attention_wgmma: wgmma,
            fa.flash_attention_mma: mma, fa.flash_attention_wide: 0}


def logits_checks(cfg, lm, params, prompts, plain_kw: dict, tol: float,
                  out: dict | None = None, fault=None) -> None:
    """Prefill logits against the same forward on the plain version(s), and
    decode at position S from the prefilled cache against a prefill of S+1
    tokens, both by rel-L2. The prefill logits and first token are the
    served run's ``out``, or a fresh prefill's without it. With ``fault``
    (what, LM keywords that plant it), that forward must miss the plain one
    by more than ``tol``: the check can fail a wrong kernel."""
    import torch

    from repro_torch.models import LM

    dev = lm.device
    S = prompts.shape[1]
    with torch.inference_mode():
        plain_logits, _ = LM(cfg, device=dev, **plain_kw).prefill(params, prompts)
        if out is None:
            got, _ = lm.prefill(params, prompts)
            tok0 = got.argmax(-1)
        else:
            got, tok0 = out["prefill_logits"], out["tokens"][:, 0]
        e_plain = rel_l2(got, plain_logits)
        print(f"  {cfg.dtype}, {tuple(prompts.shape)} prompt: prefill vs plain "
              f"{'/'.join(plain_kw)}: rel_l2={e_plain:.3g} "
              f"max_abs={float((got - plain_logits).abs().max()):.3g} (tol rel_l2 {tol})")
        if not e_plain <= tol:
            fail(f"{cfg.name} {cfg.dtype} prefill logits disagree with the plain "
                 f"{'/'.join(plain_kw)} forward")
        if fault is not None:
            what, fault_kw = fault
            faulty, _ = LM(cfg, device=dev, **fault_kw).prefill(params, prompts)
            e_fault = rel_l2(faulty, plain_logits)
            print(f"  {cfg.dtype}: planted fault ({what}) vs plain: rel_l2={e_fault:.3g} "
                  f"(must exceed {tol})")
            if not e_fault > tol:
                fail(f"the {cfg.name} {cfg.dtype} prefill check passes a planted fault "
                     f"({what})")
            del faulty

        _, cache = lm.prefill(params, prompts, max_seq=S + 1)
        step_logits, _ = lm.decode_step(params, cache, tok0, S)
        del cache
        longer, _ = lm.prefill(params, torch.cat([prompts, tok0[:, None]], 1))
        e_cache = rel_l2(step_logits, longer)
        print(f"  {cfg.dtype}: decode_step at {S} vs prefill of {S + 1}: "
              f"rel_l2={e_cache:.3g} max_abs={float((step_logits - longer).abs().max()):.3g} "
              f"(tol rel_l2 {tol})")
        if not e_cache <= tol:
            fail(f"{cfg.name} {cfg.dtype} decode from the prefilled cache disagrees with "
                 f"a longer prefill")


def serve_counted(cfg, lm, params, prompts, want: dict) -> tuple[dict, dict]:
    """Serve ``prompts`` with every counter of ``want`` set to 0 just before
    the run and read just after; fail unless each counted ``want[counter]``
    launches. Returns the served output and the counts."""
    import torch

    from repro_torch.launch.serve import report, serve

    dev = lm.device
    serve(lm, params, prompts, 2)  # warm-up: cuBLAS and allocator start-up
    for counter in want:
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    out = serve(lm, params, prompts, SERVE_NEW)
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
    if toks.shape != (SERVE_BATCH, SERVE_NEW + 1) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"bad generated tokens: shape {tuple(toks.shape)}")
    for key in ("prefill_logits", "last_logits"):
        if out[key].shape != (SERVE_BATCH, cfg.vocab_size) or \
                out[key].dtype != torch.float32 or not torch.isfinite(out[key]).all():
            fail(f"{key}: want finite f32 [{SERVE_BATCH}, {cfg.vocab_size}]")
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
                  f32_layers: int | None = None,
                  long_prompt: int | None = None) -> tuple[dict, dict | None]:
    """Serve ``arch`` at full width with its kernels' launches counted
    (``want``: counter -> launches the run must make), then the correctness
    checks. With ``f32_tol`` the logits checks are repeated on the model in
    f32, where rounding does not hide a fault, at ``f32_layers`` of its
    layers if given (full width), on a served f32 run counted like the
    first if ``want_f32`` is given; ``fault`` plants a fault that the bf16
    check must fail. ``long_prompt``: the checks again, in both dtypes, on
    one prompt of that many tokens, with the sliding window left out as the
    planted fault. Last, the reduced model on the card against the CPU.
    Returns the launches of the served runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import LM

    t0 = time.perf_counter()
    phase(f"serve {arch}")
    dev = card()
    cfg = get_config(arch)
    lm, params = init_model(cfg)
    prompts = torch.from_numpy(
        make_prompts(SERVE_BATCH, SERVE_PROMPT, cfg.vocab_size, 0)).to(dev)
    long_prompts = None if long_prompt is None else torch.from_numpy(
        make_prompts(1, long_prompt, cfg.vocab_size, 2)).to(dev)
    out, launches = serve_counted(cfg, lm, params, prompts, want)
    logits_checks(cfg, lm, params, prompts, plain_kw, rel_tol, out=out, fault=fault)
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
                  f"({cfg.param_count() * 4 / 1e9:.1f} GB) do not fit the card")
        lm32, params32 = init_model(cfg32)
        out32 = None
        if want_f32 is not None:
            out32, launches32 = serve_counted(cfg32, lm32, params32, prompts, want_f32)
        logits_checks(cfg32, lm32, params32, prompts, plain_kw, f32_tol, out=out32)
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
        want_small = cpu_lm.forward_logits(cpu_params, small_tokens)
        got = gpu_lm.forward_logits(gpu_params, small_tokens.to(dev)).cpu()
        e_small, ok = compare(got, want_small, REDUCED_F32_TOL)
        print(f"  reduced f32 model ({small.num_layers} layers; its kernels at the reduced "
              f"shape), card vs CPU: max_abs_err={e_small:.3g} (rtol = atol = {REDUCED_F32_TOL})")
        if not ok:
            fail(f"the reduced {arch} on the card disagrees with the CPU")
    print(f"serve {arch}: phase took {time.perf_counter() - t0:.1f} s")
    return launches, launches32


def serving_phases(fa, ssd, flash_attention_ref, ssd_scan_ref) -> None:
    """The hybrid zamba2-7b and the three dense configs beyond llama3.2-1b,
    each at full width and depth in bf16 and again in f32 (internlm2-20b's
    f32 at ``INTERNLM2_F32_LAYERS`` layers)."""
    from repro_torch.configs import get_config

    z = get_config("zamba2-7b")
    groups = z.num_layers // z.hybrid_attn_period
    zamba_want = {**flash_want(fa, mma=groups), ssd.ssd_scan: z.num_layers}
    check_serving("zamba2-7b", zamba_want,
                  dict(attention=flash_attention_ref, ssd_scan=ssd_scan_ref),
                  HYBRID_BF16_REL_TOL, f32_tol=HYBRID_F32_REL_TOL, fault=scan_fault(),
                  want_f32=zamba_want)
    for arch, route in (("chatglm3-6b", "wgmma"), ("internlm2-20b", "wgmma"),
                        ("h2o-danube-3-4b", "mma")):
        L = get_config(arch).num_layers
        L32 = INTERNLM2_F32_LAYERS if arch == "internlm2-20b" else L
        check_serving(arch, flash_want(fa, **{route: L}), dict(attention=flash_attention_ref),
                      LOGITS_REL_TOL, f32_tol=LLAMA_F32_REL_TOL,
                      want_f32=flash_want(fa, mma=L32), f32_layers=L32,
                      long_prompt=WINDOW_PROMPT if get_config(arch).sliding_window else None)


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
    if launches["flash_attention_wgmma"] != 2 * layers or launches["flash_attention_bwd"] != layers:
        fail(f"flash launches in the data-parallel runs {launches}: want the wgmma forward "
             f"{2 * layers} times and the backward {layers}")
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
    print(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 2. build -------------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {sorted(logs)} in {build_s:.1f} s")
    for name, log in logs.items():
        if name in ("flash_attention_bwd", "ssd_scan_bwd"):  # by pass below
            continue
        for line in log.splitlines():
            if any(key in line for key in ("registers", "spill", "(C75")):
                print(f"  {name}: {line.strip()}")
    for row in bwd_ptxas(logs["flash_attention_bwd"]):
        print(f"  ptxas, backward: {row}")
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
    times = {name: [] for name in timed}
    for _ in range(3):  # in turns, so drift hits all alike
        for name, (fn, reps) in timed.items():
            times[name].append(time_ms(torch, fn, reps))
    times = {name: statistics.median(vals) for name, vals in times.items()}
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
    # peak memory while serving counts the model alone (fn: the last closure)
    del timed, slice_in, fn

    # the wgmma route at head_dim 128 (chatglm3, internlm2, llava), the same
    # B, S, H, KV, and the mma route in bf16 at the yardstick shapes, beside
    # SDPA: printed, not in the kernels line (no path here runs them)
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

    # 8. train full-width llama3.2-1b, mamba2-370m and zamba2-7b at 13
    # layers; 9. the data-parallel step -------------------------------------
    train_launches = training_phase(torch, dev, get_config, LM, fa, flash_attention_ref,
                                    flash_attention_bwd_ref)
    ssm_launches = ssm_training_phase(torch, dev, fa, ssd, "mamba2-370m")
    ssm_training_phase(torch, dev, fa, ssd, "zamba2-7b", layers=ZAMBA2_TRAIN_LAYERS)
    dp_phase(torch, dev, fa)

    # 10. the collective path; 11. repaired plans ----------------------------
    D = collective_phase(torch, dev, get_config, LM)
    plan_repair_phase(torch, dev, D)

    # 12. per-kernel numbers ------------------------------------------------
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
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": flash_source + "flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:227",
        "launches": train_launches["flash_attention_bwd"],
        "max_abs_err": bwd["err"],
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound"][0],
        "bound_by": bwd["bound"][1],
        "library_ms": bwd["library_ms"],
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
    }]}))
    # 13. result -------------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
