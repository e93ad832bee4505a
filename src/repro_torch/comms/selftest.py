"""Numerical selftest of the port's PCCL executor on the stacked backend.

    python -m repro_torch.comms.selftest [--device cpu]

The counterpart of ``repro/comms/selftest.py``: the same seven cases, each
collective run with every rank of the program held in one tensor on one
device (the card unless ``--device cpu``) and checked against a plain numpy
reference. Ends with ``[selftest] ALL PASS`` and exit code 0; a failed check
raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.comms.primitives import (
    CollectiveSpec,
    pccl_all_gather,
    pccl_all_reduce,
    pccl_all_to_all,
    pccl_reduce_scatter,
)
from repro_torch.device import resolve_device
from repro_torch.topology import line, ring, torus2d


def check(name, got, want, atol=1e-6):
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=atol, err_msg=name)
    print(f"  ok: {name}")


def test_all_gather_ring(dev):
    topo = ring(8, bidirectional=True)
    spec = CollectiveSpec("all_gather", tuple(range(8)))
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    got = pccl_all_gather(torch.from_numpy(x).to(dev), topo, spec)
    check("all_gather ring8", got, np.broadcast_to(x, (8, 8, 4)))


def test_all_gather_subgroup_with_forwarding(dev):
    """Process group {0, 3, 7} on a line: chunks MUST forward through
    out-of-group devices 1, 2, 4, 5, 6 -- the paper's section 4.3 scenario."""
    topo = line(8)
    group = (0, 3, 7)
    spec = CollectiveSpec("all_gather", group)
    x = np.arange(8 * 2, dtype=np.float32).reshape(8, 2)
    got = pccl_all_gather(torch.from_numpy(x).to(dev), topo, spec)
    for d in range(8):
        want = x[list(group)] if d in group else np.zeros((3, 2), np.float32)
        check(f"subgroup AG at dev {d}", got[d], want, atol=0)


def test_all_reduce(dev):
    topo = ring(8, bidirectional=True)
    spec = CollectiveSpec("all_reduce", tuple(range(8)))
    x = np.arange(8 * 8, dtype=np.float32).reshape(8, 8) * 0.25
    got = pccl_all_reduce(torch.from_numpy(x).to(dev), topo, spec)
    check("all_reduce ring8 vs sum", got, np.broadcast_to(x.sum(0), (8, 8)))


def test_reduce_scatter(dev):
    topo = ring(8, bidirectional=True)
    spec = CollectiveSpec("reduce_scatter", tuple(range(8)))
    x = np.arange(8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    got = pccl_reduce_scatter(torch.from_numpy(x).to(dev), topo, spec)
    check("reduce_scatter ring8 vs sum", got, x.sum(0))


def test_all_to_all_torus_rows(dev):
    """A2A over the full 8-device group on a 2x4 torus."""
    topo = torus2d(2, 4)
    spec = CollectiveSpec("all_to_all", tuple(range(8)))
    x = np.arange(8 * 8 * 2, dtype=np.float32).reshape(8, 8, 2)
    got = pccl_all_to_all(torch.from_numpy(x).to(dev), topo, spec)
    check("all_to_all torus2x4 vs transpose", got, x.transpose(1, 0, 2))


def test_all_to_all_subgroup(dev):
    """A2A among process group {0,2,5} of a line-8: PG-aware forwarding."""
    topo = line(8)
    group = (0, 2, 5)
    spec = CollectiveSpec("all_to_all", group)
    x = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    got = pccl_all_to_all(torch.from_numpy(x).to(dev), topo, spec)
    for i, d in enumerate(group):
        want = np.stack([x[src, i] for src in group])
        check(f"subgroup A2A at dev {d}", got[d], want)


def test_two_axis_flattened(dev):
    """The executor over a flattened (r, c) grid of 2 x 4 ranks -- the
    full-pod execution mode: rank (r, c) is device 4 r + c."""
    topo = torus2d(2, 4)
    spec = CollectiveSpec("all_gather", tuple(range(8)))
    x = np.arange(8 * 2, dtype=np.float32).reshape(2, 4, 2)
    got = pccl_all_gather(torch.from_numpy(x).to(dev).reshape(8, 2), topo, spec)
    got = got.reshape(2, 4, 8, 2)
    for r in range(2):
        for c in range(4):
            check(f"flattened-axes AG rank ({r}, {c})", got[r, c], x.reshape(8, 2))


TESTS = [
    test_all_gather_ring,
    test_all_gather_subgroup_with_forwarding,
    test_all_reduce,
    test_reduce_scatter,
    test_all_to_all_torus_rows,
    test_all_to_all_subgroup,
    test_two_axis_flattened,
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; nothing falls back")
    dev = resolve_device(ap.parse_args(argv).device)
    print(f"[selftest] device {dev}")
    for t in TESTS:
        print(f"[selftest] {t.__name__}")
        t(dev)
    print("[selftest] ALL PASS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
