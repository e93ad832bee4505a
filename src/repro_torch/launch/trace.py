"""Where serving time goes on the card: the serve workload of
``chip_smoke.py`` (a full-width model, batch 4, prompts of 1024 tokens)
under ``torch.profiler``, one phase at a time.

    PYTHONPATH=src python -m repro_torch.launch.trace                     # llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.trace --arch mamba2-370m
    PYTHONPATH=src python -m repro_torch.launch.trace --dtype float32    # llama in f32

After one untraced warm-up, traces one prefill and then 8 greedy decode
steps, each phase in its own profiler session, and prints per phase:
host wall time (ending in a synchronise), device-busy time (the union of
the kernels' intervals), the busy share, device time by kind (the flash
attention kernels of both routes, the SSD scan's kernels, matrix products,
everything else)
and the top kernels.
Needs a card; exits non-zero if the profiler records no kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import make_prompts, serve
from repro_torch.models import LM

_FLASH = re.compile(r"flash_fwd_(wgmma|mma|wide)_kernel")
# the SSD scan's three passes (csrc/ssd_scan.cu)
_SSD = re.compile(r"ssd_(chunk_state|state_pass|chunk_out)_kernel")
_MATMUL = re.compile(r"gemm|gemv|xmma|cutlass|cublas|nvjet", re.I)


def kind_of(kernel: str) -> str:
    """The port's own kernels by symbol (the three flash routes, the SSD
    scan's passes), before the library products, whose names a kernel's template
    arguments may also contain."""
    if _FLASH.search(kernel):
        return "flash_attention"
    if _SSD.search(kernel):
        return "ssd_scan"
    return "matmul" if _MATMUL.search(kernel) else "other"


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals, in us."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def traced(fn, device) -> dict:
    """Run ``fn`` once under the profiler; wall and device-busy times."""
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no kernel on the card")
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
    by_kind = defaultdict(float)
    for name, us in by_name.items():
        by_kind[kind_of(name)] += us
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    return {"wall_us": wall_us, "busy_us": busy, "launches": len(kernels),
            "by_kind": dict(by_kind), "by_name": dict(by_name)}


def print_phase(name: str, r: dict, per: int, top: int) -> None:
    total = sum(r["by_kind"].values())
    print(f"{name}: wall {r['wall_us'] / per / 1e3:.3f} ms, device busy "
          f"{r['busy_us'] / per / 1e3:.3f} ms ({r['busy_us'] / r['wall_us']:.1%} "
          f"of wall, idle {1 - r['busy_us'] / r['wall_us']:.1%}), "
          f"{r['launches'] / per:.0f} kernels" + (" per step" if per > 1 else ""))
    for kind, us in sorted(r["by_kind"].items(), key=lambda kv: -kv[1]):
        print(f"  {kind:16s} {us / per / 1e3:9.3f} ms  {us / total:6.1%}")
    for kname, us in sorted(r["by_name"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {us / per / 1e3:9.3f} ms  {kname[:100]}")


BATCH, PROMPT_LEN, DECODE_STEPS, SEED, TOP = 4, 1024, 8, 0, 8


def main(argv=()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    help="serve in this dtype instead of the config's")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    cfg = get_config(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    lm = LM(cfg, device=device)
    params = lm.init(SEED)
    B, S, n = BATCH, PROMPT_LEN, DECODE_STEPS
    prompts = torch.from_numpy(
        make_prompts(B, S, cfg.vocab_size, SEED)).to(device)
    print(f"{cfg.name} ({cfg.dtype}) on {torch.cuda.get_device_name(device)}: batch {B}, "
          f"prompt {S}, {n} decode steps")
    serve(lm, params, prompts, 2)  # warm-up

    with torch.inference_mode():
        state = {}

        def prefill():
            state["logits"], state["cache"] = lm.prefill(
                params, prompts, max_seq=S + n)

        def decode():
            tok = state["logits"].argmax(-1)
            for i in range(n):
                logits, _ = lm.decode_step(params, state["cache"], tok, S + i)
                tok = logits.argmax(-1)

        print_phase("prefill", traced(prefill, device), 1, TOP)
        print_phase("decode", traced(decode, device), n, TOP)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
