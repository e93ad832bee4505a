"""Whether ``trace.traced`` keeps every kernel of a short call as a process
ages on the card. Every few seconds of matrix-product load, one profiler
session of five 0.2 ms elementwise kernels on its own (no margin, no spin
kernels) and one through ``traced``; prints the kernels each recorded, the
sessions ``traced`` took and the margins it held at each end after.

    PYTHONPATH=src python -m repro_torch.launch.profile_probe --seconds 240

Needs a card; exits non-zero if ``traced`` returned another count than 5.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import trace

CALLS, LOAD_S = 5, 6.0


def bare_session(fn, device) -> int:
    """Kernels one profiler session records of ``fn``, with nothing around it."""
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def margins() -> str:
    return ", ".join(f"{end} {trace.MARGINS_S[i]} s" for end, i in trace._held.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    args = ap.parse_args(argv)
    device = torch.device("cuda:0")
    a = torch.randn(4096, 4096, device=device, dtype=torch.bfloat16)
    x = torch.zeros(64 << 20, device=device)

    def calls():
        for _ in range(CALLS):
            x.add_(1.0)

    start, rows = time.perf_counter(), []
    while time.perf_counter() - start < args.seconds:
        t = time.perf_counter()
        while time.perf_counter() - t < LOAD_S:
            for _ in range(50):
                a = (a @ a).clamp_(-1, 1)
            torch.cuda.synchronize(device)
        bare = bare_session(calls, device)
        r = trace.traced(calls, device)
        got = r["launches"]
        rows.append((bare, got))
        print(f"t={time.perf_counter() - start:6.1f} s: bare session {bare} of {CALLS} "
              f"kernels, traced {got} of {CALLS} in {r['sessions']} session(s) "
              f"(margins {margins()})", flush=True)
    bare_whole = sum(b == CALLS for b, _ in rows)
    traced_whole = sum(g == CALLS for _, g in rows)
    print(f"profile_probe: {len(rows)} rounds; bare sessions whole {bare_whole}, traced "
          f"whole {traced_whole}; margins at the end {margins()}")
    return 0 if traced_whole == len(rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
