"""Where serving time goes on the card: the serve workload of
``chip_smoke.py`` (a full-width model, batch 4, prompts of 1024 tokens;
``--prompt-len`` sets another) under ``torch.profiler``, one phase at a
time.

    PYTHONPATH=src python -m repro_torch.launch.trace                     # llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.trace --arch mamba2-370m
    PYTHONPATH=src python -m repro_torch.launch.trace --arch zamba2-7b   # the hybrid
    PYTHONPATH=src python -m repro_torch.launch.trace --arch granite-moe-1b-a400m  # moe
    PYTHONPATH=src python -m repro_torch.launch.trace --arch granite-moe-3b-a800m
    PYTHONPATH=src python -m repro_torch.launch.trace --arch whisper-medium --prompt-len 416
    PYTHONPATH=src python -m repro_torch.launch.trace --arch llava-next-34b  # vlm
    PYTHONPATH=src python -m repro_torch.launch.trace --dtype float32    # llama in f32

After one untraced warm-up, traces one prefill (over whisper's stub audio
frames, behind llava's stub image patches: ``data.pipeline.stub_inputs``)
and then 8 greedy decode steps, each phase in its own profiler session,
and prints per phase: host wall time (ending in a synchronise),
device-busy time (the union of the kernels' intervals), the busy share,
device time by kind (the flash attention kernels of both routes, the SSD
scan's kernels, matrix products, everything else), by range (a moe
model's dispatch, experts and combine, forward and backward) and the top
kernels.
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
from repro_torch.data.pipeline import stub_inputs
from repro_torch.device import resolve_device
from repro_torch.launch.serve import make_prompts, prefix_len, serve
from repro_torch.models import LM

_FLASH = re.compile(r"flash_fwd_(wgmma|mma|wide)_kernel")
# the flash backward's three passes, of either route (csrc/flash_attention_bwd.cu,
# csrc/flash_attention_bwd_wgmma.cu)
_FLASH_BWD = re.compile(r"flash_bwd_(?:wgmma_)?(lse|dkdv|dq)_kernel")
# the SSD scan's three passes (csrc/ssd_scan.cu)
_SSD = re.compile(r"ssd_(chunk_state|state_pass|chunk_out)_kernel")
# the SSD backward's own passes (csrc/ssd_scan_bwd.cu); the states it
# recomputes through the forward's passes (a) and (b) count as ssd_scan
_SSD_BWD = re.compile(r"ssd_bwd_(scores|rev|carry|chunk|inter|dbc|sum|dA)_kernel")
_MATMUL = re.compile(r"gemm|gemv|xmma|cutlass|cublas|nvjet", re.I)


def kind_of(kernel: str) -> str:
    """The port's own kernels by symbol (the three flash routes, the flash
    backward's passes, the SSD scan's and its backward's passes), before
    the library products, whose names a kernel's template arguments may
    also contain."""
    if _FLASH.search(kernel):
        return "flash_attention"
    if _FLASH_BWD.search(kernel):
        return "flash_attention_bwd"
    if _SSD.search(kernel):
        return "ssd_scan"
    if _SSD_BWD.search(kernel):
        return "ssd_scan_bwd"
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


# record_function ranges of the port's model code (models/moe.py) that a
# traced step's device time is split by
RANGES = ("moe.dispatch", "moe.experts", "moe.combine")


def range_of(event, fwd_ranges: dict) -> str | None:
    """The range of ``RANGES`` an op ran in: the nearest enclosing one; for
    an op under an autograd node (the backward), the range of the forward
    op that made the node, found in ``fwd_ranges`` by the node's forward
    thread and sequence number. Remat's recompute runs inside the backward,
    under its own ranges, which are nearer."""
    e = event
    while e is not None:
        if e.name in RANGES:
            return e.name
        if e.sequence_nr >= 0 and "Backward" in e.name:
            return fwd_ranges.get((e.fwd_thread, e.sequence_nr))
        e = e.cpu_parent
    return None


def forward_ranges(events) -> dict:
    """(thread, sequence number) -> range of every forward op in a range."""
    out = {}
    for e in events:
        if e.sequence_nr >= 0 and "Backward" not in e.name:
            r = range_of(e, {})
            if r is not None:
                out[(e.thread, e.sequence_nr)] = r
    return out


def by_range(events) -> dict:
    """Device time (us) of the kernels launched by ops in each range (the
    profiler links a kernel to the op that launched it)."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    fwd = forward_ranges(cpu)
    out = defaultdict(float)
    for e in cpu:
        r = range_of(e, fwd) if e.kernels else None
        if r is not None:
            out[r] += sum(k.duration for k in e.kernels)
    return dict(out)


# On the card's machine a profiler session can lose the records of kernels
# at either end of it. Kernels launched as the session opens are lost over
# a span that grows with the process's age (all five 0.2 ms kernels of a
# session from ~85 s in); a 50 ms idle margin keeps them, but now and then,
# in bursts, a session still loses its first kernels, or every kernel after
# its first few in several processes at once (``launch/profile_probe.py``
# shows the first kind). So ``fn`` runs between two sets of ``PADS`` short spin
# kernels, each set apart from it by a synchronise and from the session's
# start or end by an idle margin: where a leading and a trailing spin kernel
# are recorded, the kernels of ``fn`` between them are too. A session that
# lost an end runs again (``fn`` again) with that end's margin one step
# wider in ``MARGINS_S``, up to ``SESSIONS`` sessions a call, then
# ``traced`` raises. A session that kept both ends leaves each end's margin
# one step narrower for the next call, so a burst does not widen every
# later session. The spin kernels are left out of every number ``traced``
# returns.
MARGINS_S = (0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2, 6.4)
SESSIONS = 12
_held = {"leading": 0, "trailing": 0}  # index in MARGINS_S of each end's margin
PADS, PAD_CYCLES = 3, 200_000


def _is_pad(name: str) -> bool:
    return "spin_kernel" in name


def _pads(device, margin: float, *, leading: bool) -> None:
    """Spin kernels with the idle margin on the session's side of them."""
    torch.cuda.synchronize(device)
    if leading:
        time.sleep(margin)
    with torch.cuda.device(device):
        for _ in range(PADS):
            torch.cuda._sleep(PAD_CYCLES)
    torch.cuda.synchronize(device)
    if not leading:
        time.sleep(margin)


def _ends(kernels) -> dict:
    """Whether a session kept each end, from its kernels' (name, start): a
    spin kernel before the first of the other kernels, and one after the
    last of them, in the card's order (neither where there is no other
    kernel)."""
    order = [name for _, name in sorted((start, name) for name, start in kernels)]
    inner = [i for i, name in enumerate(order) if not _is_pad(name)]
    return {"leading": bool(inner) and inner[0] > 0,
            "trailing": bool(inner) and inner[-1] < len(order) - 1}


def _raw_kernels(prof) -> list:
    """(name, start) of a session's device events, from the profiler's raw
    records: a session that lost an end is judged without building its
    events, which takes seconds for a training step's. A range's annotation
    lies within ``fn``'s kernels, so it moves neither end."""
    return [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def _step(held: dict, kept: dict) -> dict:
    """Each end's margin index for the next session: one wider where the
    session lost that end, one narrower where it kept it, within
    ``MARGINS_S``."""
    return {end: max(i - 1, 0) if kept[end] else min(i + 1, len(MARGINS_S) - 1)
            for end, i in held.items()}


def traced(fn, device) -> dict:
    """Run ``fn`` once under the profiler; wall and device-busy times, device
    time by kernel kind, by kernel and by range (``RANGES``), and the
    sessions it took. A session that may have lost kernels of ``fn`` is run
    again with a wider margin at the end it lost, up to ``SESSIONS`` in
    all, then raises."""
    for session in range(1, SESSIONS + 1):
        margin = {end: MARGINS_S[i] for end, i in _held.items()}
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _pads(device, margin["leading"], leading=True)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            wall_us = (time.perf_counter() - t0) * 1e6
            _pads(device, margin["trailing"], leading=False)
        kept = _ends(_raw_kernels(prof))
        _held.update(_step(_held, kept))
        if all(kept.values()):
            break
    else:
        raise RuntimeError(f"the profiler lost kernels on the card at an end of each of "
                           f"{SESSIONS} sessions (margins up to {MARGINS_S[-1]} s)")
    # a record_function range also appears on the card's timeline, as a user
    # annotation spanning its kernels: not a kernel
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not _is_pad(e.name)
               and not getattr(e, "is_user_annotation", False) and e.name not in RANGES]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
    by_kind = defaultdict(float)
    for name, us in by_name.items():
        by_kind[kind_of(name)] += us
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    return {"wall_us": wall_us, "busy_us": busy, "launches": len(kernels),
            "by_kind": dict(by_kind), "by_name": dict(by_name),
            "by_range": by_range(prof.events()), "sessions": session}


def print_phase(name: str, r: dict, per: int, top: int) -> None:
    total = sum(r["by_kind"].values())
    print(f"{name}: wall {r['wall_us'] / per / 1e3:.3f} ms, device busy "
          f"{r['busy_us'] / per / 1e3:.3f} ms ({r['busy_us'] / r['wall_us']:.1%} "
          f"of wall, idle {1 - r['busy_us'] / r['wall_us']:.1%}), "
          f"{r['launches'] / per:.0f} kernels" + (" per step" if per > 1 else "")
          + (f" ({r['sessions']} profiler sessions)" if r.get("sessions", 1) > 1 else ""))
    for kind, us in sorted(r["by_kind"].items(), key=lambda kv: -kv[1]):
        print(f"  {kind:16s} {us / per / 1e3:9.3f} ms  {us / total:6.1%}")
    for rng, us in r.get("by_range", {}).items():
        print(f"  range {rng:12s} {us / per / 1e3:9.3f} ms  {us / total:6.1%}")
    for kname, us in sorted(r["by_name"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {us / per / 1e3:9.3f} ms  {kname[:100]}")


BATCH, PROMPT_LEN, DECODE_STEPS, SEED, TOP = 4, 1024, 8, 0, 8


def main(argv=()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--prompt-len", type=int, default=PROMPT_LEN,
                    help="tokens a prompt (whisper-medium: 416, of its 448-token context)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    help="serve in this dtype instead of the config's")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    cfg = get_config(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    lm = LM(cfg, device=device)
    params = lm.init(SEED)
    B, S, n = BATCH, args.prompt_len, DECODE_STEPS
    prompts = torch.from_numpy(
        make_prompts(B, S, cfg.vocab_size, SEED)).to(device)
    stub = {name: torch.from_numpy(x).to(device)
            for name, x in stub_inputs(cfg, B, SEED).items()}
    start = S + prefix_len(stub)
    print(f"{cfg.name} ({cfg.dtype}) on {torch.cuda.get_device_name(device)}: batch {B}, "
          f"prompt {S}, {n} decode steps"
          + "".join(f", {name} {tuple(x.shape)}" for name, x in stub.items()))
    serve(lm, params, prompts, 2, **stub)  # warm-up

    with torch.inference_mode():
        state = {}

        def prefill():
            state["logits"], state["cache"] = lm.prefill(
                params, prompts, max_seq=start + n, **stub)

        def decode():
            tok = state["logits"].argmax(-1)
            for i in range(n):
                logits, _ = lm.decode_step(params, state["cache"], tok, start + i)
                tok = logits.argmax(-1)

        print_phase("prefill", traced(prefill, device), 1, TOP)
        print_phase("decode", traced(decode, device), n, TOP)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
