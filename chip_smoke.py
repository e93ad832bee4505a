#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. the card: nvidia-smi's name and power limit, torch's device name; TF32 off;
2. build the CUDA kernels from the sources in this checkout (nvcc, sm_90a);
3. hold the flash-attention kernel against its plain PyTorch version on the
   card at the test shapes and at the serving shape, and time it there
   beside the plain version and, as a yardstick the port never calls,
   ``torch.nn.functional.scaled_dot_product_attention``;
4. serve full-width llama3.2-1b (bf16, seeded random weights): 4 prompts of
   1024 tokens, one-pass prefill, 32 greedy decode steps, with the kernel's
   launches counted over that run; then check the prefill against the same
   forward with the plain attention, the cache against a prefill one token
   longer, and the reduced model on the card against the CPU;
5. print one JSON line of per-kernel numbers;
6. print the result line ``{"ok": true, "device": {...}}`` last.

Imports nothing of jax or of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

F32_TOL = 2e-5
BF16_TOL = 2e-2
# bf16 model logits: relative L2 error ||a - b|| / ||b||. The two sides of
# each comparison round to bf16 at different places (kernel vs plain
# attention output order; decode's bf16 scores and probabilities vs the
# kernel's f32), and 16 layers compound it.
LOGITS_REL_TOL = 5e-2
REDUCED_F32_TOL = 1e-4

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
    (SLICE_SHAPE[0], SLICE_SHAPE[1], SLICE_SHAPE[1], *SLICE_SHAPE[2:],
     "bfloat16", dict(causal=True)),                                  # the slice
]


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
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth (each
    input read once, the output written once) and the two products' FLOPs
    over the peak rate of the inputs' type."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    flops = 4 * B * H * hd * visible_pairs(S, T, causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    dtype = str(q.dtype).removeprefix("torch.")
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


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
    from repro_torch.kernels.ref import flash_attention_ref
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
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernel against its plain version ---------------------------------
    phase("kernel checks")
    gen = torch.Generator(device=dev).manual_seed(0)
    slice_err = None
    for B, S, T, H, KV, hd, dt, kw in CHECK_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(dtype)
        got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, **kw)
        tol = F32_TOL if dt == "float32" else BF16_TOL
        err, ok = compare(got, want, tol)
        print(f"  B={B} S={S} T={T} H={H} KV={KV} hd={hd} {dt} {kw}: "
              f"max_abs_err={err:.3g} (tol {tol}) {'ok' if ok else 'FAIL'}")
        if not (ok and torch.isfinite(got).all()):
            fail(f"kernel disagrees with its plain version at {(B, S, T, H, KV, hd, dt, kw)}")
        if (B, S, H, KV, hd) == SLICE_SHAPE:
            slice_err = err

    B, S, H, KV, hd = SLICE_SHAPE
    q = torch.randn((B, S, H, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, KV, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, KV, hd), generator=gen, device=dev).bfloat16()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kernel_fn = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    plain_fn = lambda: flash_attention_ref(q, k, v, causal=True)  # noqa: E731
    sdpa_fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    torch.testing.assert_close(sdpa_fn().transpose(1, 2).float(),
                               kernel_fn().float(), rtol=BF16_TOL, atol=BF16_TOL)
    times = {"ms": [], "plain_ms": [], "library_ms": []}
    for _ in range(3):  # in turns, so drift hits all three alike
        times["ms"].append(time_ms(torch, kernel_fn, 20))
        times["plain_ms"].append(time_ms(torch, plain_fn, 5))
        times["library_ms"].append(time_ms(torch, sdpa_fn, 20))
    times = {key: statistics.median(vals) for key, vals in times.items()}
    bound_ms, bound_by, flops, nbytes = attention_bound(q, k, v, True, 0)
    print(f"  slice shape {SLICE_SHAPE} bf16 causal: kernel {times['ms']:.4f} ms, "
          f"plain {times['plain_ms']:.4f} ms, sdpa {times['library_ms']:.4f} ms; "
          f"bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
          f"kernel at {flops / times['ms'] / 1e9:.2f} TFLOP/s")

    # 4. serve -----------------------------------------------------------
    phase("serve llama3.2-1b")
    cfg = get_config("llama3.2-1b")
    lm = LM(cfg, device=dev)
    params = lm.init(0)
    print(f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B params, {cfg.dtype}, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}")
    prompts = torch.from_numpy(
        make_prompts(SERVE_BATCH, SERVE_PROMPT, cfg.vocab_size, 0)).to(dev)
    serve(lm, params, prompts, 2)  # warm-up: cuBLAS and allocator start-up

    fa.flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    out = serve(lm, params, prompts, SERVE_NEW)
    launches = fa.flash_attention.launches
    peak = torch.cuda.max_memory_allocated(dev)
    print(report(out))
    print(f"serve: prefill_ms={out['prefill_s'] * 1e3:.3f} "
          f"decode_ms_per_token={out['decode_s'] * 1e3 / SERVE_NEW:.3f} "
          f"decode_tok_per_s={SERVE_BATCH * SERVE_NEW / out['decode_s']:.1f} "
          f"max_memory_allocated={peak} B ({peak / 2**30:.2f} GiB) "
          f"flash_attention_launches={launches}")
    if launches != cfg.num_layers:
        fail(f"flash_attention launched {launches} times in one prefill, "
             f"want {cfg.num_layers} (one per layer)")
    toks = out["tokens"]
    if toks.shape != (SERVE_BATCH, SERVE_NEW + 1) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"bad generated tokens: shape {tuple(toks.shape)}")
    for key in ("prefill_logits", "last_logits"):
        if out[key].shape != (SERVE_BATCH, cfg.vocab_size) or \
                out[key].dtype != torch.float32 or not torch.isfinite(out[key]).all():
            fail(f"{key}: want finite f32 [{SERVE_BATCH}, {cfg.vocab_size}]")

    with torch.inference_mode():
        plain_lm = LM(cfg, device=dev, attention=flash_attention_ref)
        plain_logits, _ = plain_lm.prefill(params, prompts)
        e_plain = rel_l2(out["prefill_logits"], plain_logits)
        print(f"  prefill vs plain attention: rel_l2={e_plain:.3g} "
              f"max_abs={float((out['prefill_logits'] - plain_logits).abs().max()):.3g} "
              f"(tol rel_l2 {LOGITS_REL_TOL})")
        if not e_plain <= LOGITS_REL_TOL:
            fail("prefill logits disagree with the plain-attention forward")

        tok0 = out["tokens"][:, 0]
        _, cache = lm.prefill(params, prompts, max_seq=SERVE_PROMPT + 1)
        step_logits, _ = lm.decode_step(params, cache, tok0, SERVE_PROMPT)
        longer, _ = lm.prefill(params, torch.cat([prompts, tok0[:, None]], 1))
        e_cache = rel_l2(step_logits, longer)
        print(f"  decode_step at S vs prefill of S+1: rel_l2={e_cache:.3g} "
              f"max_abs={float((step_logits - longer).abs().max()):.3g} "
              f"(tol rel_l2 {LOGITS_REL_TOL})")
        if not e_cache <= LOGITS_REL_TOL:
            fail("decode from the prefilled cache disagrees with a longer prefill")

        small = cfg.reduced(dtype="float32")
        cpu_lm, gpu_lm = LM(small, device="cpu"), LM(small, device=dev)
        cpu_params = cpu_lm.init(0)
        gpu_params = to_device(cpu_params, dev)
        small_tokens = torch.from_numpy(make_prompts(2, 100, small.vocab_size, 1))
        want = cpu_lm.forward_logits(cpu_params, small_tokens)
        got = gpu_lm.forward_logits(gpu_params, small_tokens.to(dev)).cpu()
        e_small, ok = compare(got, want, REDUCED_F32_TOL)
        print(f"  reduced f32 model (kernel at hd=32), card vs CPU: "
              f"max_abs_err={e_small:.3g} (rtol = atol = {REDUCED_F32_TOL})")
        if not ok:
            fail("the reduced model on the card disagrees with the CPU")

    # 5. per-kernel numbers -------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": launches,
        "max_abs_err": slice_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": times["library_ms"],
    }]}))
    # 6. result --------------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
