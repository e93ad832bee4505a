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
   (head_dim 112 and 120 included), strided views of a fused projection and
   the serving shape, each call counted on the route that the table names;
   then time both at the serving shape beside the plain version, the bound
   and, as a yardstick the port never calls,
   ``torch.nn.functional.scaled_dot_product_attention``; and the mma route
   in bf16 at the training slice's shape and at head_dim 120 and 112 beside
   SDPA (printed only); the wide route at head_dim 512 beside its plain
   version and SDPA;
4. hold the SSD chunked-scan kernel (output and final state) against its
   plain version (the token-by-token recurrence) on the card at the test
   shapes, a ragged S, S < chunk and the serving shape, and again with a
   slow decay that carries the state across many chunks (the slice, 32
   chunks, a chunk of 100, grids smaller and larger than the card), and at
   the (P, N) the wrapper slices or pads, (128, 256) and (48, 96); then
   time it at the serving shape beside the plain version (no single
   PyTorch call computes it) and its bound, the faster of the f32 CUDA
   cores and the TF32 tensor cores at three products (3xTF32), or bytes;
5. serve full-width llama3.2-1b (bf16, seeded random weights): 4 prompts of
   1024 tokens, one-pass prefill, 32 greedy decode steps, with each flash
   route's launches counted over that run (all 16 on the wgmma route); then
   check the prefill against the same forward with the plain attention, the
   cache against a prefill one token longer; serve and check the same model
   in f32 (all 16 launches on the mma route), and the reduced model on
   the card against the CPU;
6. the same for full-width mamba2-370m, with the SSD kernel's launches
   counted and the plain SSD scan as the comparison, a planted fault that
   the bf16 check must reject, and the checks repeated in f32;
7. the collective path: the executor's selftest on the card; the four
   fig_exec routes (8 ranks, 4096 f32 a shard) with their round and send
   counts, bit for bit against the port's numpy round interpreter and
   within 1e-5 of a plain sum; and the all-reduce of mamba2-370m's f32
   gradient vector over a bidirectional ring of 8 ranks held in one tensor
   on the card, bit for bit on a column sample, against ``x.sum(0)``, with
   exact zeros off a subgroup of 5, timed beside ``x.sum(0)``;
8. print one JSON line of per-kernel numbers;
9. print the result line ``{"ok": true, "device": {...}}`` last.

Imports nothing of jax or of the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
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
    # head dims above 256: the wide route
    *[(1, 300, 300, 4, 2, hd, dt, kw) for hd in (320, 512) for dt in ("float32", "bfloat16")
      for kw in (dict(causal=True, window=96, softcap=20.0), dict(causal=True))],
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
      for hd in (112, 120) for dt in ("float32", "bfloat16")],
]
# the mma route in bf16, timed beside SDPA (causal): B, S, H, KV, hd
YARDSTICKS = {
    "the 10m training model": (8, 256, 8, 4, 32),
    "h2o-danube-3-4b's head_dim": (SERVE_BATCH, SERVE_PROMPT, 32, 8, 120),
    "zamba2-7b's head_dim": (SERVE_BATCH, SERVE_PROMPT, 32, 32, 112),
}

# the wide route, timed beside its plain version and SDPA (causal): B, S, H, KV, hd
WIDE_SHAPE = (2, 1024, 8, 2, 512)

SSD_SLICE = (SERVE_BATCH, SERVE_PROMPT, 32, 64, 128, 128)  # B, S, H, P, N, chunk
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
    # sizes the kernel is not built for: P and N sliced or padded, chunk cut
    *[(1, 300, 4, P, N, chunk, slow) for P, N in ((128, 256), (48, 96))
      for chunk, slow in ((128, False), (256, True))],
]

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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def visible_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible: the work attention must do."""
    total = 0
    for s in range(S):
        hi = min(T - 1, s) if causal else T - 1
        lo = max(0, s - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def attention_bound(q, k, v, causal, window):
    """(bound_ms, bound_by, flops, bytes, terms): the larger of bytes over
    HBM bandwidth (each input read once, the output written once) and the
    two products' FLOPs over the peak rate of the inputs' type. f32 takes
    the faster of two routes that keep f32 accuracy, as ``ssd_bound`` does:
    the f32 CUDA cores, or the TF32 tensor cores at three products each
    (3xTF32; one TF32 product misses the f32 tolerance). ``terms`` holds
    each time in ms."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    flops = 4 * B * H * hd * visible_pairs(S, T, causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    if q.dtype.is_floating_point and q.element_size() == 4:
        terms = {"f32_ms": flops / PEAK_FLOPS["float32"] * 1e3,
                 "3xtf32_ms": 3 * flops / PEAK_FLOPS["tf32"] * 1e3}
    else:
        terms = {"bf16_ms": flops / PEAK_FLOPS["bfloat16"] * 1e3}
    t_ops = min(terms.values())
    terms["bytes_ms"] = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, terms["bytes_ms"]),
            "operations" if t_ops >= terms["bytes_ms"] else "bytes", flops, nbytes, terms)


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


def compare(got, want, tol: float) -> tuple[float, bool]:
    """(max abs error, whether |got - want| <= tol + tol * |want| everywhere
    and got is finite): allclose with rtol = atol = tol."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return float(diff.max()), ok


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


def collective_phase(torch, dev, get_config, LM) -> None:
    """The executor's selftest, the fig_exec routes and the all-reduce of
    mamba2-370m's gradient vector, on the stacked backend on the card."""
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

    def check_all_reduce(x, group, label):
        """Run once, then: a column sample of every chunk bit for bit
        against the numpy interpreter, members within EXEC_TOL of the sum,
        non-members exact zeros."""
        sub_req = CollectiveRequest("all_reduce", group=tuple(group))
        out = primitives.pccl_all_reduce(x, topo, sub_req)
        L = x.shape[1] // len(group)
        cols = np.sort(np.random.default_rng(2).choice(L, SAMPLE_COLS, replace=False))
        idx = torch.from_numpy((np.arange(len(group))[:, None] * L + cols).reshape(-1)).to(dev)
        x_s = x.index_select(1, idx).cpu().numpy()
        got_s = out.index_select(1, idx).cpu().numpy()
        interp = primitives.interpret_collective("all_reduce", x_s, topo, sub_req)
        if not np.array_equal(got_s.view(np.uint32), interp.view(np.uint32)):
            fail(f"{label}: the card's result differs from the numpy interpreter on "
                 f"the column sample")
        total = x[group[0]].clone()  # x[group].sum(0) without a copy of x[group]
        for d in group[1:]:
            total += x[d]
        err = 0.0
        for d in range(n):
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
        del out, total

    check_all_reduce(x, tuple(range(n)), "all-reduce, 8 of 8 ranks")
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
    check_all_reduce(x.view(-1)[:n * D5].view(n, D5), SUBGROUP,
                     f"all-reduce, subgroup {SUBGROUP} of 8 ranks")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"collectives: all_reduce_ms={got['pccl']:.3f} sum_ms={got['sum']:.3f} "
          f"rounds_bytes={rounds_bytes} call_bytes={call_bytes} "
          f"bound_ms={io_bytes / PEAK_BYTES * 1e3:.3f} launches={launches} "
          f"max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB)")
    del x, timed
    executor.clear_plan_cache()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

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
    from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_ref
    from repro_torch.launch.serve import make_prompts, report, serve
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
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(key in line for key in ("registers", "spill", "(C75")):
                print(f"  {name}: {line.strip()}")

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

    def time_pair(fns: dict, reps: int) -> dict:
        """Median ms of each function over three rounds in turns."""
        got = {name: [] for name in fns}
        for _ in range(3):
            for name, fn in fns.items():
                got[name].append(time_ms(torch, fn, reps))
        return {name: statistics.median(vals) for name, vals in got.items()}

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
        got = time_pair(pair, 100)
        bound_ms, bound_by, flops, nbytes, terms = attention_bound(q, k, v, True, 0)
        print(f"  {label}: {shape} bfloat16 causal: kernel {got['kernel']:.4f} ms, sdpa "
              f"{got['sdpa']:.4f} ms ({got['kernel'] / got['sdpa']:.2f}x); bound "
              f"{bound_ms * 1e3:.2f} us by {bound_by} ({bound_terms(terms)}); kernel at "
              f"{flops / got['kernel'] / 1e9:.2f} TFLOP/s, "
              f"{got['kernel'] / bound_ms:.2f}x its bound")
        del q, k, v, qt, kt, vt, pair

    # the wide route (head_dim above 256) beside its plain version and SDPA:
    # f32 goes to the kernels line, bf16 is printed
    wide = {}
    for dt in ("float32", "bfloat16"):
        (q, k, v), (qt, kt, vt) = attention_inputs(torch, gen, dev, WIDE_SHAPE, dt)
        fns = {"kernel": lambda: fa.flash_attention_wide(q, k, v, causal=True),
               "plain": lambda: flash_attention_ref(q, k, v, causal=True),
               "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True)}
        got = fns["kernel"]()
        err, ok = compare(got, fns["plain"](), F32_TOL if dt == "float32" else BF16_TOL)
        if not ok:
            fail(f"the wide kernel disagrees with its plain version at {WIDE_SHAPE} {dt}")
        torch.testing.assert_close(got.float(), fns["sdpa"]().transpose(1, 2).float(),
                                   rtol=BF16_TOL, atol=BF16_TOL)
        got = time_pair(fns, 5)
        bound = attention_bound(q, k, v, True, 0)
        print(f"  wide route: {WIDE_SHAPE} {dt} causal: kernel {got['kernel']:.4f} ms, plain "
              f"{got['plain']:.4f} ms, sdpa {got['sdpa']:.4f} ms "
              f"({got['kernel'] / got['sdpa']:.2f}x SDPA); max_abs_err {err:.3g}; bound "
              f"{bound[0] * 1e3:.2f} us by {bound[1]} ({bound_terms(bound[4])}); kernel at "
              f"{bound[2] / got['kernel'] / 1e9:.2f} TFLOP/s, {got['kernel'] / bound[0]:.2f}x "
              f"its bound")
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

    # 5. and 6. serve each model through its kernel -------------------------
    def diagonal_dropped(scan):
        """``scan`` with a planted fault, an off-by-one causal mask: y_i
        leaves out its own position's term (C_i . B_i) dt_i x_i."""
        def faulty(xh, dt, A, Bm, Cm, *, chunk, return_state=False):
            out = scan(xh, dt, A, Bm, Cm, chunk=chunk, return_state=return_state)
            y = out[0] if return_state else out
            y = y - (Cm * Bm).sum(-1)[..., None, None] * dt[..., None] * xh
            return (y, out[1]) if return_state else y
        return faulty

    def logits_checks(cfg, lm, params, prompts, plain_kw: dict, tol: float,
                      out: dict | None = None, fault_kw: dict | None = None) -> None:
        """Prefill logits against the same forward on the plain version(s),
        and decode at position S from the prefilled cache against a prefill
        of S+1 tokens, both by rel-L2. The prefill logits and first token are
        the served run's ``out``, or a fresh prefill's without it. With
        ``fault_kw`` (LM arguments that plant a fault), that forward must
        miss the plain one by more than ``tol``: the check can fail a wrong
        kernel."""
        with torch.inference_mode():
            plain_logits, _ = LM(cfg, device=dev, **plain_kw).prefill(params, prompts)
            if out is None:
                got, _ = lm.prefill(params, prompts)
                tok0 = got.argmax(-1)
            else:
                got, tok0 = out["prefill_logits"], out["tokens"][:, 0]
            e_plain = rel_l2(got, plain_logits)
            print(f"  {cfg.dtype}: prefill vs plain {'/'.join(plain_kw)}: "
                  f"rel_l2={e_plain:.3g} max_abs={float((got - plain_logits).abs().max()):.3g} "
                  f"(tol rel_l2 {tol})")
            if not e_plain <= tol:
                fail(f"{cfg.dtype} prefill logits disagree with the plain "
                     f"{'/'.join(plain_kw)} forward")
            if fault_kw is not None:
                faulty, _ = LM(cfg, device=dev, **fault_kw).prefill(params, prompts)
                e_fault = rel_l2(faulty, plain_logits)
                print(f"  {cfg.dtype}: planted fault (off-by-one causal mask) vs "
                      f"plain: rel_l2={e_fault:.3g} (must exceed {tol})")
                if not e_fault > tol:
                    fail(f"the {cfg.dtype} prefill check passes a planted fault")

            _, cache = lm.prefill(params, prompts, max_seq=SERVE_PROMPT + 1)
            step_logits, _ = lm.decode_step(params, cache, tok0, SERVE_PROMPT)
            longer, _ = lm.prefill(params, torch.cat([prompts, tok0[:, None]], 1))
            e_cache = rel_l2(step_logits, longer)
            print(f"  {cfg.dtype}: decode_step at S vs prefill of S+1: rel_l2={e_cache:.3g} "
                  f"max_abs={float((step_logits - longer).abs().max()):.3g} "
                  f"(tol rel_l2 {tol})")
            if not e_cache <= tol:
                fail(f"{cfg.dtype} decode from the prefilled cache disagrees with "
                     f"a longer prefill")

    def serve_counted(cfg, lm, params, prompts, want: dict) -> tuple[dict, dict]:
        """Serve ``prompts`` with every counter of ``want`` set to 0 just
        before the run and read just after; fail unless each counted
        ``want[counter]`` launches. Returns the served output and the counts."""
        serve(lm, params, prompts, 2)  # warm-up: cuBLAS and allocator start-up
        for counter in want:
            counter.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        out = serve(lm, params, prompts, SERVE_NEW)
        launches = {counter: counter.launches for counter in want}
        peak = torch.cuda.max_memory_allocated(dev)
        print(report(out))
        print(f"serve {cfg.dtype}: prefill_ms={out['prefill_s'] * 1e3:.3f} "
              f"decode_ms_per_token={out['decode_s'] * 1e3 / SERVE_NEW:.3f} "
              f"decode_tok_per_s={SERVE_BATCH * SERVE_NEW / out['decode_s']:.1f} "
              f"max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB) " +
              " ".join(f"{c.__name__}_launches={n}" for c, n in launches.items()))
        for counter, n in want.items():
            if launches[counter] != n:
                fail(f"{counter.__name__} launched {launches[counter]} times in one "
                     f"{cfg.dtype} prefill of {cfg.num_layers} layers, want {n}")
        toks = out["tokens"]
        if toks.shape != (SERVE_BATCH, SERVE_NEW + 1) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            fail(f"bad generated tokens: shape {tuple(toks.shape)}")
        for key in ("prefill_logits", "last_logits"):
            if out[key].shape != (SERVE_BATCH, cfg.vocab_size) or \
                    out[key].dtype != torch.float32 or not torch.isfinite(out[key]).all():
                fail(f"{key}: want finite f32 [{SERVE_BATCH}, {cfg.vocab_size}]")
        return out, launches

    def check_serving(arch: str, want: dict, plain_kw: dict, rel_tol: float,
                      f32_tol: float | None = None, fault_kw: dict | None = None,
                      want_f32: dict | None = None) -> tuple[dict, dict | None]:
        """Serve ``arch`` at full width with its kernels' launches counted
        (``want``: counter -> launches the run must make), then the
        correctness checks. With ``f32_tol`` the logits checks are repeated
        on the same model in f32, where rounding does not hide a fault, on a
        served f32 run counted like the first if ``want_f32`` is given;
        ``fault_kw`` plants a fault that the bf16 check must fail. Returns
        the launches of the served runs."""
        phase(f"serve {arch}")
        cfg = get_config(arch)
        lm = LM(cfg, device=dev)
        params = lm.init(0)
        print(f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B params, {cfg.dtype}, "
              f"{cfg.num_layers} layers, d_model {cfg.d_model}")
        prompts = torch.from_numpy(
            make_prompts(SERVE_BATCH, SERVE_PROMPT, cfg.vocab_size, 0)).to(dev)
        out, launches = serve_counted(cfg, lm, params, prompts, want)
        logits_checks(cfg, lm, params, prompts, plain_kw, rel_tol, out=out,
                      fault_kw=fault_kw)
        del lm, params
        launches32 = None
        if f32_tol is not None:
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            lm32 = LM(cfg32, device=dev)
            params32 = lm32.init(0)
            out32 = None
            if want_f32 is not None:
                out32, launches32 = serve_counted(cfg32, lm32, params32, prompts, want_f32)
            logits_checks(cfg32, lm32, params32, prompts, plain_kw, f32_tol, out=out32)
            del lm32, params32

        with torch.inference_mode():
            small = cfg.reduced(dtype="float32")
            cpu_lm, gpu_lm = LM(small, device="cpu"), LM(small, device=dev)
            cpu_params = cpu_lm.init(0)
            gpu_params = to_device(cpu_params, dev)
            small_tokens = torch.from_numpy(make_prompts(2, 100, small.vocab_size, 1))
            want = cpu_lm.forward_logits(cpu_params, small_tokens)
            got = gpu_lm.forward_logits(gpu_params, small_tokens.to(dev)).cpu()
            e_small, ok = compare(got, want, REDUCED_F32_TOL)
            print(f"  reduced f32 model (its kernel at the reduced shape), card vs "
                  f"CPU: max_abs_err={e_small:.3g} (rtol = atol = {REDUCED_F32_TOL})")
            if not ok:
                fail("the reduced model on the card disagrees with the CPU")
        return launches, launches32

    layers = get_config("llama3.2-1b").num_layers
    flash, flash32 = check_serving(
        "llama3.2-1b",
        {fa.flash_attention: layers, fa.flash_attention_wgmma: layers,
         fa.flash_attention_mma: 0, fa.flash_attention_wide: 0},
        dict(attention=flash_attention_ref), LOGITS_REL_TOL, f32_tol=LLAMA_F32_REL_TOL,
        want_f32={fa.flash_attention: layers, fa.flash_attention_wgmma: 0,
                  fa.flash_attention_mma: layers, fa.flash_attention_wide: 0})
    ssd_launches, _ = check_serving(
        "mamba2-370m", {ssd.ssd_scan: get_config("mamba2-370m").num_layers},
        dict(ssd_scan=ssd_scan_ref), SSM_BF16_REL_TOL, f32_tol=SSM_F32_REL_TOL,
        fault_kw=dict(ssd_scan=diagonal_dropped(ops.ssd_scan)))

    # 7. the collective path -------------------------------------------------
    collective_phase(torch, dev, get_config, LM)

    # 8. per-kernel numbers -------------------------------------------------
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
    }]}))
    # 9. result --------------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
