"""The port's dry run (``launch/dryrun.py``), its cost model
(``launch/op_cost.py``) and the kernels' ``torch.library`` operators
(``kernels/ops.py``) against the JAX package's dry run and cost model, on
the CPU.

The cases that need a fake process group (4, 2, 1 and 256 ranks) run in one
process of their own, ``tests/_torch_dryrun_worker.py``, started once by a
module fixture: the default group is process-wide. The reference's side
(its ``build_bundle`` stand-ins and specs on a stand-in mesh, its jitted
steps' HLO through ``hlo_cost.analyze``) runs here.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402, F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import steps as jst  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import named_leaves, params_from_jax  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCHS = sorted(jconfigs.REGISTRY)
POD = (("data", "model"), (16, 16))
GEMM_TOL = 1e-2  # per-device GEMM FLOPs at tp 2 against half of tp 1's
PRODUCT_TOL = 1e-2  # the port's GEMMs against the reference's dots
TOTAL_TOL = 3e-2  # total FLOPs against hlo_cost's, attention counted as the reference's
GEMMS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm")


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    """The fake-group cases' numbers (``_torch_dryrun_worker.py``)."""
    out = tmp_path_factory.mktemp("dryrun") / "worker.json"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")])}
    done = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_dryrun_worker.py"),
                           str(out)], env=env, capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(out.read_text())


# ---------------------------------------------------------------------------
# (i) the operators: fake outputs as the kernels lay them out, opcheck
# ---------------------------------------------------------------------------

def _flash_inputs(B=2, S=16, T=16, H=4, KV=2, hd=8, dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, H, hd, generator=gen).to(dtype)
    k, v = (torch.randn(B, T, KV, hd, generator=gen).to(dtype) for _ in range(2))
    o = ops.flash_attention(q, k, v)
    return q, k, v, o, torch.randn(o.shape, generator=gen).to(dtype)


def _ssd_inputs(B=2, S=12, H=3, P=4, N=5):
    gen = torch.Generator().manual_seed(1)
    xh = torch.randn(B, S, H, P, generator=gen)
    dt = torch.rand(B, S, H, generator=gen)
    A = -torch.rand(H, generator=gen)
    Bm, Cm = (torch.randn(B, S, N, generator=gen) for _ in range(2))
    return xh, dt, A, Bm, Cm, torch.randn(B, S, H, P, generator=gen)


def _op_cases():
    q, k, v, o, do = _flash_inputs()
    qb, kb, vb, ob, dob = _flash_inputs(S=8, T=24, dtype=torch.bfloat16)
    xh, dt, A, Bm, Cm, dy = _ssd_inputs()
    return {
        "flash causal": (ops.OPS.flash_attention.default, (q, k, v, True, 0, 0.0)),
        "flash window softcap bf16": (ops.OPS.flash_attention.default,
                                      (qb, kb, vb, False, 5, 2.0)),
        "flash bwd": (ops.OPS.flash_attention_bwd.default, (q, k, v, o, do, True, 3, 0.0)),
        "ssd state": (ops.OPS.ssd_scan.default, (xh, dt, A, Bm, Cm, 4, True)),
        "ssd": (ops.OPS.ssd_scan.default, (xh, dt, A, Bm, Cm, 5, False)),
        "ssd bwd": (ops.OPS.ssd_scan_bwd.default, (xh, dt, A, Bm, Cm, dy, 4)),
    }


def _layout(out):
    out = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype, t.stride()) for t in out]


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_fake_outputs_on_cuda_match_the_plain_version(case):
    """Each operator's fake outputs on fake CUDA inputs have the shapes,
    dtypes and strides of the plain version's real outputs on the CPU:
    contiguous, as the kernels allocate them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args = _op_cases()[case]
    want = op(*args)
    with FakeTensorMode():
        fake = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device="cuda")
                if isinstance(a, torch.Tensor) else a for a in args]
        got = op(*fake)
    for t in got if isinstance(got, tuple) else (got,):
        assert t.device.type == "cuda"
    assert _layout(got) == _layout(want)
    assert all(t.is_contiguous() for t in (want if isinstance(want, tuple) else (want,)))


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_opcheck_on_cpu(case):
    op, args = _op_cases()[case]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_ops_give_the_plain_versions_bits_and_raise_elsewhere():
    """The entry points go through the operators and give the plain
    versions' values on the CPU; a meta tensor still raises, as before."""
    from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_bwd_ref, ssd_scan_ref

    q, k, v, _, _ = _flash_inputs()
    assert torch.equal(ops.flash_attention(q, k, v, window=3),
                       flash_attention_ref(q, k, v, window=3))
    xh, dt, A, Bm, Cm, dy = _ssd_inputs()
    y, state = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=4, return_state=True)
    wy, wstate = ssd_scan_ref(xh, dt, A, Bm, Cm, return_state=True)
    assert torch.equal(y, wy) and torch.equal(state, wstate)
    # under a dispatch mode the plain backward's autograd runs in its own thread
    got, _ = op_cost.analyze(ops.ssd_scan_bwd, xh, dt, A, Bm, Cm, dy, chunk=4)
    for g, w in zip(got, ssd_scan_bwd_ref(xh, dt, A, Bm, Cm, dy, chunk=4)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="no flash_attention for device meta"):
        ops.flash_attention(*(t.to("meta") for t in (q, k, v)))


def test_flop_formulas():
    """The operators' FLOP formulas: visible pairs x 4 hd forward, x 10 hd
    backward; the SSD scan's products by its chunked arithmetic."""
    from repro_torch.kernels.ref import _visible

    assert tfa.visible_pairs(4, 4, True, 0) == 10
    for S, T, causal, window in ((5, 7, False, 0), (6, 6, True, 2), (3, 8, False, 2),
                                 (9, 7, True, 4), (7, 3, True, 0)):
        want = int(_visible(S, T, causal, window, "cpu").sum())  # the plain version's mask
        assert tfa.visible_pairs(S, T, causal, window) == want, (S, T, causal, window)
    assert tfa.flops((2, 4, 3, 8), (2, 4, 1, 8), True, 0) == 2 * 3 * 4 * 8 * 10
    assert tfa.flops((2, 4, 3, 8), (2, 4, 1, 8), True, 0, backward=True) == 2 * 3 * 10 * 8 * 10
    q, k, v, o, do = _flash_inputs()
    _, fwd = op_cost.analyze(ops.flash_attention, q, k, v, window=3)
    _, bwd = op_cost.analyze(ops.flash_attention_bwd, q, k, v, o, do, window=3)
    pairs = tfa.visible_pairs(16, 16, True, 3)
    assert fwd.flops_by_op == {"repro_torch.flash_attention": 2 * 4 * 4 * 8 * pairs}
    assert bwd.flops_by_op == {"repro_torch.flash_attention_bwd": 2 * 4 * 10 * 8 * pairs}
    assert fwd.transcendentals == bwd.transcendentals == 2 * 4 * pairs
    # one chunk of q = 4: pairs 10; scores 10 N 2, per head 10 P 2 + 2 q N P 2
    B, S, H, P, N = 1, 4, 2, 3, 5
    assert tssd.flops((B, S, H, P), N, 4) == 10 * N * 2 + H * (10 * P * 2 + 2 * 4 * N * P * 2)
    # the kernel runs at most MAX_CHUNK; a shorter last chunk counts its own pairs
    assert tssd.flops((1, 300, 1, 1), 1, 1000) == tssd.flops((1, 300, 1, 1), 1, 128)
    assert tssd.flops((1, 5, 1, 1), 1, 4, backward=True) == (
        (3 * 10 * 2 + 10 + 2 * 10 * 2 + 3 * 4 * 2) + (3 * 1 * 2 + 1 + 2 * 1 * 2 + 2 * 1 * 2))


# ---------------------------------------------------------------------------
# (ii) the counting rules on hand-made functions
# ---------------------------------------------------------------------------

def test_matmul_and_exp_counts():
    a, b = torch.randn(6, 5), torch.randn(5, 7)
    out, cost = op_cost.analyze(torch.mm, a, b)
    assert cost.flops == 2 * 6 * 5 * 7 and cost.transcendentals == 0
    assert cost.bytes == (6 * 5 + 5 * 7 + 6 * 7) * 4
    assert cost.peak_bytes == 6 * 7 * 4 and out.shape == (6, 7)
    _, cost = op_cost.analyze(torch.exp, torch.randn(3, 4, dtype=torch.bfloat16))
    assert (cost.flops, cost.transcendentals, cost.bytes) == (12, 12, 2 * 12 * 2)
    # views, casts and reductions cost nothing; an add is one FLOP an element
    x = torch.randn(4, 4)
    _, cost = op_cost.analyze(lambda t: (t.t().float().sum(0) + 1.0), x)
    assert cost.flops == 4 and cost.flops_by_op == {"aten.add": 4}
    assert cost.collective_bytes == {} and cost.total_collective_bytes == 0
    # a square is a multiply, not a transcendental
    _, cost = op_cost.analyze(torch.square, x)
    assert (cost.flops, cost.transcendentals) == (16, 0)


def test_peak_follows_live_storages():
    """Storages freed during the call leave the live total: two 1 KiB
    temporaries one after the other peak at 2 KiB with the result."""
    def fn(x):
        y = x * 2.0  # 1 KiB
        z = y + 1.0  # 1 KiB, y still alive
        del y
        return z * 3.0  # 1 KiB; z alive, y gone
    _, cost = op_cost.analyze(fn, torch.zeros(256))
    assert cost.peak_bytes == 2 * 1024
    c = op_cost.Cost(flops=1.0, collective_bytes={"all-gather": 2})
    c.add(op_cost.Cost(flops=2.0, collective_bytes={"all-gather": 1, "all-reduce": 4}), 2)
    assert (c.flops, c.collective_bytes) == (5.0, {"all-gather": 4, "all-reduce": 8})
    assert c.total_collective_bytes == 12


def test_dtensor_collectives_by_kind(worker):
    """On a fake group of 4: [16, 32] f32 split on rows gathered whole is
    one all-gather of 2 KiB (its result); a Partial [8, 8] f32 summed is
    one all-reduce of 256 B."""
    gather, reduce = worker["collectives"]["gather"], worker["collectives"]["reduce"]
    assert gather == [{"all-gather": 16 * 32 * 4}, {"all-gather": 1}]
    assert reduce == [{"all-reduce": 8 * 8 * 4}, {"all-reduce": 1}]


# ---------------------------------------------------------------------------
# (iii) per device, not global
# ---------------------------------------------------------------------------

def _halves(tp1: float, tp2: float) -> bool:
    return abs(tp2 - tp1 / 2) <= GEMM_TOL * tp1 / 2


def test_gemm_flops_are_per_device(worker):
    """A Megatron MLP block and full-width llama3.2-1b's prefill (2 x 32
    tokens) at tp 2 against tp 1: each rank's GEMM FLOPs halve. The planted
    counter, ``FlopCounterMode`` above DTensor, counts the global work the
    same at both and must fail that check."""
    mlp = worker["mlp"]
    T, d, h = 8, 64, 256
    assert mlp["1"]["op_cost"] == 2 * 2 * T * d * h
    assert _halves(mlp["1"]["op_cost"], mlp["2"]["op_cost"])
    assert mlp["2"]["all-reduce"] == 1  # the row-parallel partial sums
    assert mlp["1"]["global"] == mlp["1"]["op_cost"]
    assert not _halves(mlp["1"]["global"], mlp["2"]["global"])  # planted: global shapes
    pre = worker["prefill"]
    assert pre["1"]["status"] == pre["2"]["status"] == "ok", (pre["1"]["error"], pre["2"]["error"])
    gemm = [sum(v for k, v in pre[tp]["gemm"].items() if k in GEMMS) for tp in ("1", "2")]
    assert gemm[0] > 0 and _halves(*gemm)
    assert _halves(pre["1"]["gemm"]["repro_torch.flash_attention"],
                   pre["2"]["gemm"]["repro_torch.flash_attention"])


# ---------------------------------------------------------------------------
# (iv) parity with the reference
# ---------------------------------------------------------------------------

def _pairs(args, specs, path=()):
    """(path, ShapeDtypeStruct, PartitionSpec) of the reference's bundle
    args and in_shardings (dicts, ``AdamWState`` and tuples walked)."""
    if isinstance(args, dict):
        for k in args:
            yield from _pairs(args[k], specs[k], (*path, k))
    elif hasattr(args, "_fields"):
        for k in args._fields:
            yield from _pairs(getattr(args, k), getattr(specs, k), (*path, k))
    elif isinstance(args, jax.ShapeDtypeStruct):
        yield path, args, specs
    else:
        for i, (a, s) in enumerate(zip(args, specs)):
            yield from _pairs(a, s, (*path, i))


def _reference_bytes(bundle, axis_sizes: dict) -> int:
    """The reference's per-device argument bytes: each stand-in's shard,
    rounded up, at the port's dtypes: token ids at 8 bytes (int64 against
    int32), and neither the AdamW counter nor the decode position, which
    the port holds as Python ints."""
    total = 0
    for path, leaf, spec in _pairs(tuple(bundle.args), tuple(bundle.in_shardings)):
        if path[-1] == "step" or (bundle.shape.kind == "decode" and path == (3,)):
            assert leaf.shape == () and str(leaf.dtype) == "int32", path
            continue
        local = []
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * len(leaf.shape)):
            names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            local.append(-(-dim // math.prod(axis_sizes[n] for n in names)))
        token = str(leaf.dtype) == "int32"
        total += math.prod(local) * (8 if token else np.dtype(leaf.dtype).itemsize)
    return total


def test_argument_bytes_match_reference_on_every_pod_cell(worker, monkeypatch):
    """All 40 cells on the pod mesh: the port's placed arguments' local
    bytes equal the reference's per-device bytes from its stand-ins and
    specs (``_reference_bytes``)."""
    monkeypatch.setattr(jsh.ShardingPolicy, "named", lambda self, spec: spec)
    names, shape = POD
    jmesh = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
    got = worker["pod"]["argument_bytes"]
    assert len(got) == 40
    for arch in ARCHS:
        for shape_name in jconfigs.SHAPES:
            want = _reference_bytes(jst.build_bundle(arch, shape_name, jmesh),
                                    dict(zip(names, shape)))
            assert got[f"{arch}|{shape_name}"] == want, (arch, shape_name)


def _reduced_f32(module, arch):
    return dataclasses.replace(module.get_config(arch).reduced(), dtype="float32")


class _Everything(set):
    def __contains__(self, item):
        return True


def _reference_costs(arch: str, B: int, S: int, monkeypatch):
    """hlo_cost over the reference's jitted loss + backward and prefill of
    the reduced f32 config: (total Cost, dots-only Cost) of each, and the
    params, config and batch the port's side takes."""
    cfg = _reduced_f32(jconfigs, arch)
    lm = JLM(cfg)
    params = lm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens, labels = (rng.integers(0, cfg.vocab_size, (B, S)) for _ in range(2))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    texts = {
        "loss": jax.jit(lambda p, b: jax.value_and_grad(lm.loss, has_aux=True)(p, b))
        .lower(params, batch).compile().as_text(),
        "prefill": jax.jit(lm.forward_logits).lower(params, batch).compile().as_text(),
    }
    totals = {k: hlo_cost.analyze(t) for k, t in texts.items()}
    with monkeypatch.context() as m:  # every op but the products costs nothing
        m.setattr(hlo_cost, "_ELEMENTWISE_TRANS", set())
        m.setattr(hlo_cost, "_ZERO_COST_OPS", _Everything())
        dots = {k: hlo_cost.analyze(t) for k, t in texts.items()}
    return totals, dots, params, cfg, {"tokens": tokens, "labels": labels}


def test_flops_match_hlo_cost(monkeypatch):
    """The reduced f32 llama3.2-1b's loss + backward and prefill (B 2, S 64,
    one process, no policy) counted by ``op_cost`` against ``hlo_cost`` over
    the reference's compiled HLO. One op class differs by design:
    attention. The reference's dense ``attend`` multiplies every (query,
    key) pair, S T, in its two products, and autodiff makes them four in the
    backward; the port's kernel operators count the visible pairs, S (S + 1)
    / 2, and five products in the backward (S recomputed). So: the port's
    GEMMs equal the reference's dots less its attention products within 1%;
    the attention operators count their formula; and the totals, with the
    port's attention counted as the reference computes it, are within 3%
    (the rest is elementwise counting: softmax, norms, the optimizer-free
    loss)."""
    B, S = 2, 64
    totals, dots, jparams, cfg, batch = _reference_costs("llama3.2-1b", B, S, monkeypatch)
    lm = TLM(dataclasses.replace(_reduced_f32(tconfigs, "llama3.2-1b")), device="cpu")
    params = params_from_jax(jparams, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def loss_and_backward(p, b):
        for _, t in named_leaves(p):
            t.requires_grad_(True)
        loss, _ = lm.loss(p, b)
        loss.backward()
        return loss

    _, loss_cost = op_cost.analyze(loss_and_backward, params, tb)
    with torch.no_grad():
        _, prefill_cost = op_cost.analyze(lm.forward_logits, params, tb["tokens"])
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    pairs = tfa.visible_pairs(S, S, True, 0)
    for kind, cost, dense_products, kernel_per_pair in (
            ("loss", loss_cost, 6, 4 + 10), ("prefill", prefill_cost, 2, 4)):
        dense = L * dense_products * 2 * B * H * S * S * hd
        gemm = sum(v for k, v in cost.flops_by_op.items() if k in GEMMS)
        attention = sum(v for k, v in cost.flops_by_op.items() if k.startswith("repro_torch."))
        want_gemm = dots[kind].flops - dense
        assert abs(gemm - want_gemm) <= PRODUCT_TOL * want_gemm, (kind, gemm, want_gemm)
        assert attention == L * B * H * hd * pairs * kernel_per_pair, kind
        as_reference = cost.flops - attention + dense
        assert abs(as_reference - totals[kind].flops) <= TOTAL_TOL * totals[kind].flops, (
            kind, as_reference, totals[kind].flops)
        assert cost.collective_bytes == {} == totals[kind].collective_bytes


# ---------------------------------------------------------------------------
# (v) a full-width production cell
# ---------------------------------------------------------------------------

def test_full_width_decode_cell_on_the_pod(worker):
    """``run_cell("llama3.2-1b", "decode_32k", "pod", ...)`` on the CPU on
    a fake group of 256: ok, the reference's record fields, collectives of
    every kind it uses, its argument bytes those of the placed stand-ins;
    long_500k skipped with the reference's reason; the CLI ends ok and
    caches."""
    cells = worker["pod"]["cells"]
    rec = cells["decode_32k"]
    assert rec["status"] == "ok", rec.get("traceback")
    for key in ("flops", "bytes_accessed", "transcendentals", "collective_bytes",
                "collective_counts", "params", "active_params", "padded_heads",
                "orig_heads", "trace_s", "total_s", "memory"):
        assert key in rec, key
    assert sorted(rec["memory"]) == ["alias_bytes", "argument_bytes", "output_bytes",
                                     "temp_bytes"]
    assert set(op_cost.COLLECTIVE_KINDS) <= set(rec["collective_bytes"])
    assert rec["collective_bytes"]["all-gather"] > 0 and rec["collective_bytes"]["all-reduce"] > 0
    assert rec["flops"] > 0 and rec["memory"]["temp_bytes"] > 0
    assert rec["memory"]["argument_bytes"] == worker["pod"]["argument_bytes"][
        "llama3.2-1b|decode_32k"]
    # the donated cache comes back as the updated cache, in place
    assert 0 < rec["memory"]["alias_bytes"] <= rec["memory"]["output_bytes"]
    assert (rec["params"], rec["padded_heads"]) == (
        jconfigs.get_config("llama3.2-1b").param_count(), 32)
    ok, why = jconfigs.shape_applicable(jconfigs.get_config("llama3.2-1b"), "long_500k")
    assert not ok
    assert cells["long_500k"] == {"arch": "llama3.2-1b", "shape": "long_500k", "mesh": "pod",
                                  "status": "skipped", "reason": why}
    cli = worker["pod"]["cli"]
    assert cli["rc"] == [0, 0] and cli["status"] == "ok"


def test_cuda_raises_without_a_cuda_torch(tmp_path):
    if torch.backends.cuda.is_built():
        pytest.skip("this torch is built with CUDA")
    with pytest.raises(RuntimeError, match="built with CUDA"):
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--mesh", "pod",
                     "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


# ---------------------------------------------------------------------------
# (vi) the launchers hand off to the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("launcher, argv, want", [
    (ttrain, ["--dry-run"], ["--arch", "llama3.2-1b", "--shape", "train_4k", "--mesh", "pod"]),
    (ttrain, ["--dry-run", "--arch", "zamba2-7b", "--shape", "prefill_32k", "--mesh",
              "multipod"],
     ["--arch", "zamba2-7b", "--shape", "prefill_32k", "--mesh", "multipod"]),
    (tserve, ["--dry-run"], ["--arch", "llama3.2-1b", "--shape", "decode_32k", "--mesh", "pod"]),
    (tserve, ["--dry-run", "--arch", "mamba2-370m", "--shape", "long_500k", "--device", "cpu"],
     ["--arch", "mamba2-370m", "--shape", "long_500k", "--mesh", "pod", "--device", "cpu"]),
])
def test_launchers_dry_run_hands_off(monkeypatch, launcher, argv, want):
    """``--dry-run`` runs the reference's child command with the port's
    module (``--device`` passed on when given), in a child process, and
    returns its exit code; nothing else starts."""
    calls = []

    def record(cmd, env=None):
        calls.append((cmd, env))
        return 3

    monkeypatch.setattr(subprocess, "call", record)
    assert launcher.main(argv) == 3
    assert len(calls) == 1
    cmd, env = calls[0]
    assert cmd == [sys.executable, "-m", "repro_torch.launch.dryrun", *want]
    assert env == dict(os.environ)


@pytest.mark.parametrize("launcher, argv", [
    (ttrain, ["--dry-run", "--mesh", "v5p"]),
    (tserve, ["--dry-run", "--mesh", "v5p"]),
    (tserve, ["--dry-run", "--shape", "train_4k"]),  # serve's cells are the decode shapes
])
def test_launchers_refuse_other_cells(monkeypatch, launcher, argv):
    monkeypatch.setattr(subprocess, "call", lambda *a, **k: pytest.fail("handed off"))
    with pytest.raises(SystemExit):
        launcher.main(argv)
