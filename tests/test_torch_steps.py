"""The port's shape table and ``launch/steps.py`` against the JAX package's,
on the CPU.

Stand-ins and specs: every (arch x shape) cell at full width on the two
production meshes (16 x 16, 2 x 16 x 16) and on 1 x 4 and 2 x 2 x 2, the
reference's ``build_bundle`` on a stand-in mesh
(``SimpleNamespace(axis_names=, devices=np.empty(shape))``, its policy's
``named`` replaced by the identity so that every sharding is its spec), the
port's on meta-device stand-ins: every argument's path, shape and dtype,
every input and output spec, the padded config. Numbers: the reduced f32
configs (both packages' ``get_config`` replaced), the reference's step
jitted on a real 1 x 1 jax mesh, the port's on a one-rank gloo group, from
the same params (``bridge.params_from_jax``) and batch: the train kind at
accum 1 and 2, the prefill and decode kinds, and one train step on two
spawned gloo ranks (1 x 2) against the port's own at 1 x 1.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402, F401
import _torch_steps_worker as steps_worker  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.jaxcompat import make_mesh as jmake_mesh  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import steps as jst  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import named_leaves, params_from_jax  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tst  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.optim import AdamWState, adamw_init  # noqa: E402

ARCHS = sorted(jconfigs.REGISTRY)
MESHES = {  # name: (axis names, sizes)
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "1x4": (("data", "model"), (1, 4)),
    "2x2x2": (("pod", "data", "model"), (2, 2, 2)),
}
LOSS_TOL = 1e-5
AUX_TOL = 1e-4
GNORM_TOL = 1e-3
STEP_TOL = 1e-3  # rel-L2 of each leaf's update (new - old)
GRAD_TOL = 1e-3  # rel-L2 of each bf16 gradient leaf
LOGITS_TOL = 1e-4
TP_TOL = 1e-4  # the 1 x 2 gloo step against the port's own at 1 x 1
B, S = 4, 16  # the numeric cases' batch


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _close(got: float, want: float, tol: float) -> bool:
    return abs(got - want) <= tol * max(abs(want), 1e-12)


def _full(x) -> np.ndarray:
    x = x.full_tensor() if hasattr(x, "full_tensor") else x
    return x.detach().float().numpy().copy()  # a copy: the step updates in place


# ---------------------------------------------------------------------------
# the shape table
# ---------------------------------------------------------------------------

def test_shape_table_matches_reference():
    assert ({k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})
    for arch in ARCHS:
        for shape in jconfigs.SHAPES:
            assert (tconfigs.shape_applicable(tconfigs.get_config(arch), shape)
                    == jconfigs.shape_applicable(jconfigs.get_config(arch), shape))
    assert list(tconfigs.all_cells()) == list(jconfigs.all_cells())
    assert len(list(tconfigs.all_cells())) == 40
    refused = [(a, s) for a, s, ok, _ in tconfigs.all_cells() if not ok]
    assert refused and all(s == "long_500k" and not tconfigs.get_config(a).sub_quadratic
                           for a, s in refused)
    assert tconfigs.ShapeSpec("x", 1, 1, "train") == tconfigs.ShapeSpec("x", 1, 1, "train")


# ---------------------------------------------------------------------------
# stand-ins and specs at full width
# ---------------------------------------------------------------------------

def _walk(ref, port, path=()):
    """(path, reference leaf, port leaf) of two trees of the same shape: the
    reference's dicts, tuples, ``AdamWState``, ``PartitionSpec`` and
    ``ShapeDtypeStruct`` leaves against the port's dicts, tuples,
    ``AdamWState``, spec tuples and meta tensors."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and sorted(port) == sorted(ref), path
        for k in ref:
            yield from _walk(ref[k], port[k], (*path, k))
    elif hasattr(ref, "_fields"):  # AdamWState
        assert isinstance(port, AdamWState), path
        for k in ref._fields:
            yield from _walk(getattr(ref, k), getattr(port, k), (*path, k))
    elif isinstance(ref, (jax.sharding.PartitionSpec, jax.ShapeDtypeStruct)):
        yield path, ref, port
    else:
        assert isinstance(ref, tuple) and isinstance(port, tuple), path
        assert len(ref) == len(port), path
        for i, (r, p) in enumerate(zip(ref, port)):
            yield from _walk(r, p, (*path, i))


def _want_dtype(path, ref) -> torch.dtype:
    name = str(ref.dtype)
    if name == "int32":  # the AdamW counter keeps int32; token ids are the port's
        return torch.int32 if "step" in path else tst.TOKEN_DTYPE
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


@pytest.fixture
def spec_mode(monkeypatch):
    monkeypatch.setattr(jsh.ShardingPolicy, "named", lambda self, spec: spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_bundles_match_reference(arch, mesh, spec_mode):
    """All four shapes of one config on one mesh: every stand-in on meta
    with the reference's path, shape and dtype, every spec, the config."""
    names, shape = MESHES[mesh]
    jmesh = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
    tm = tmesh.make_mesh(shape, names, device_type="cpu")
    for shape_name in jconfigs.SHAPES:
        ref = jst.build_bundle(arch, shape_name, jmesh)
        got = tst.build_bundle(arch, shape_name, tm)
        assert (got.arch, got.shape.name) == (arch, shape_name)
        assert dataclasses.asdict(got.shape) == dataclasses.asdict(ref.shape)
        assert dataclasses.asdict(got.cfg) == dataclasses.asdict(ref.cfg)
        assert got.donate_argnums == ref.donate_argnums
        n = 0
        for path, r, p in _walk(tuple(ref.args), got.args):
            assert isinstance(p, torch.Tensor) and p.device.type == "meta", path
            assert tuple(p.shape) == tuple(r.shape), path
            assert p.dtype == _want_dtype(path, r), (path, p.dtype, r.dtype)
            n += 1
        assert n > 5
        for tree in ("in_shardings", "out_shardings"):
            for path, r, p in _walk(getattr(ref, tree), getattr(got, tree), (tree,)):
                assert p == tuple(r), (path, p, r)


def test_stand_ins_allocate_nothing_and_need_no_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    got = tst.build_bundle("llava-next-34b", "train_4k", mesh)
    leaves = [t for _, t in named_leaves(got.args[0])] + [
        t for _, t in named_leaves(got.args[1].mu)] + list(got.args[2].values())
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for _, t in named_leaves(got.args[0])) > 30e9
    assert got.lm.policy.tp_size == 16 and got.cfg.num_heads == 64  # padded 56 -> 64
    with pytest.raises(ValueError, match="does not divide"):
        tst.build_bundle("llama3.2-1b", tconfigs.ShapeSpec("t", 8, 3, "train"),
                         tmesh.make_test_mesh(1, 1, device_type="cpu"), accum_steps=2)
    assert tst.ACCUM_STEPS == jst.ACCUM_STEPS
    assert str(tst.i32().dtype) == "torch.int32" and tst.f32(2).device.type == "meta"


@pytest.mark.parametrize("param_dtype", [torch.float32, None])
@pytest.mark.parametrize("arch", ARCHS)
def test_stand_ins_equal_a_real_init(arch, param_dtype):
    """``param_stand_ins`` and ``cache_stand_ins`` against ``init`` and
    ``decode_init`` at reduced width, leaf for leaf."""
    lm = TLM(tconfigs.get_config(arch).reduced(), device="cpu", ep_degree=3)
    real = named_leaves(lm.init(0, param_dtype=param_dtype))
    stand = named_leaves(lm.param_stand_ins(param_dtype))
    cache = named_leaves(lm.decode_init(2, 16))
    cache_stand = named_leaves(lm.cache_stand_ins(2, 16))
    for want, got in ((real, stand), (cache, cache_stand)):
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, w), (_, g) in zip(want, got):
            assert g.device.type == "meta", path
            assert (g.shape, g.dtype) == (w.shape, w.dtype), path


# ---------------------------------------------------------------------------
# numbers at reduced width
# ---------------------------------------------------------------------------

def _jcfg(arch):
    return jconfigs.get_config(arch).reduced(dtype="float32")


def _tcfg(arch):
    return tconfigs.get_config(arch).reduced(dtype="float32")


@functools.lru_cache(maxsize=None)
def _inputs(arch: str, kind: str):
    """(numpy params of the reference's init, numpy batch) for one case."""
    cfg = _jcfg(arch)
    params = jax.tree.map(np.asarray, JLM(cfg).init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "encdec":  # bf16 stub frames, exact in both packages
        frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model), np.float32)
        batch["frames"] = torch.from_numpy(frames).bfloat16().float().numpy()
    if kind == "prefill":
        batch.pop("labels")
    return params, batch


def _jbatch(batch):
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "frames" else None)
            for k, v in batch.items()}


def _tbatch(batch):
    return {k: (torch.from_numpy(v).bfloat16() if k == "frames"
                else torch.from_numpy(v).long()) for k, v in batch.items()}


def _jcast(params):
    return jax.tree.map(lambda p: p.astype(jnp.bfloat16)
                        if p.dtype == jnp.float32 and p.ndim >= 2 else p, params)


@functools.lru_cache(maxsize=None)
def _jmesh():
    return jmake_mesh((1, 1), ("data", "model"))


def _ref_bundle(arch, shape, accum=None):
    keep = jst.get_config, jst.SHAPES
    jst.get_config, jst.SHAPES = (lambda a: _jcfg(a)), {shape.name: shape}
    try:
        return jst.build_bundle(arch, shape.name, _jmesh(), accum_steps=accum)
    finally:
        jst.get_config, jst.SHAPES = keep


def _port_bundle(arch, shape, mesh, accum=None):
    keep = tst.get_config
    tst.get_config = _tcfg
    try:
        return tst.build_bundle(arch, tconfigs.ShapeSpec(shape.name, shape.seq_len,
                                                         shape.global_batch, shape.kind),
                                mesh, accum_steps=accum)
    finally:
        tst.get_config = keep


@functools.lru_cache(maxsize=None)
def _ref_train(arch: str, accum: int):
    """The reference's train step: (metrics, {"param/...", "mu/...",
    "nu/...": the updated params and moments}, the bf16 gradients at the
    compute copies when accum is 1), numpy."""
    params, batch = _inputs(arch, "train")
    bundle = _ref_bundle(arch, jconfigs.ShapeSpec("t", S, B, "train"), accum)
    jp = jax.tree.map(jnp.asarray, params)
    new, opt, metrics = bundle.jitted()(jp, jadamw_init(jp), _jbatch(batch))
    grads = None
    if accum == 1:
        jp = jax.tree.map(jnp.asarray, params)
        fn = jax.jit(jax.grad(lambda p, b: bundle.lm.loss(p, b)[0]))
        grads = jax.tree.map(lambda g: np.asarray(g, np.float32),
                             fn(_jcast(jp), _jbatch(batch)))
    state = {"param": new, "mu": opt.mu, "nu": opt.nu}
    return ({k: float(v) for k, v in metrics.items()},
            {k: np.asarray(v, np.float32) for k, v in _flat(state).items()}, grads)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process and its 1 x 1 cpu mesh."""
    import torch.distributed as dist

    where = tmp_path_factory.mktemp("rdv")
    dist.init_process_group("gloo", init_method=f"file://{where}/rdv", rank=0,
                            world_size=1)
    try:
        yield tmesh.make_test_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _flat(tree, prefix=()):
    return {"/".join(p): v for p, v in named_leaves(tree, prefix)}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m", "whisper-medium"])
def test_train_step_matches_reference(arch, accum, one_rank):
    params, batch = _inputs(arch, "train")
    want, want_new, want_grads = _ref_train(arch, accum)
    bundle = _port_bundle(arch, jconfigs.ShapeSpec("t", S, B, "train"), one_rank, accum)
    assert bundle.lm.remat and bundle.donate_argnums == (0, 1)
    placed = bundle.lm.policy.param_shardings(params_from_jax(params, "cpu", torch.float32))
    old = {k: _full(v) for k, v in _flat({"param": placed}).items()}
    tb = _tbatch(batch)
    if want_grads is not None:  # the gradients at the bf16 compute copies
        pc = tst.compute_cast(placed)
        loss, _ = bundle.lm.loss(pc, tb)
        loss.backward()
        wg = _flat(want_grads)
        for k, t in _flat(pc).items():
            assert t.grad.dtype == (torch.bfloat16 if t.ndim >= 2 else torch.float32), k
            assert _rel(_full(t.grad), wg[k]) <= GRAD_TOL, k
    new, opt, got = bundle.fn(placed, adamw_init(placed), tb)
    assert opt.step == 1 and set(got) == {"loss", "xent", "moe_aux", "grad_norm", "lr"}
    state = {k: _full(v) for k, v in _flat({"param": new, "mu": opt.mu, "nu": opt.nu}).items()}
    got = {k: float(_full(v)) for k, v in got.items()}
    assert _close(got["loss"], want["loss"], LOSS_TOL), (got, want)
    assert _close(got["moe_aux"], want["moe_aux"], AUX_TOL), (got, want)
    assert _close(got["grad_norm"], want["grad_norm"], GNORM_TOL), (got, want)
    assert _close(got["lr"], want["lr"], 1e-6)
    # the port's xent is the mean cross-entropy at every accum; the
    # reference's at accum > 1 is its total loss
    want_xent = want["xent"] if accum == 1 else want["loss"] - 0.01 * want["moe_aux"]
    assert _close(got["xent"], want_xent, LOSS_TOL), (got, want)
    steps_worker.hold_update(state, want_new, old, STEP_TOL)


def test_undivided_accum_sum_fails_the_reference_check(one_rank, monkeypatch):
    """A planted fault, the microbatches' f32 gradient sum not divided by
    accum, doubles the gradient norm that the reference check holds."""
    params, batch = _inputs("llama3.2-1b", "train")
    want, _, _ = _ref_train("llama3.2-1b", 2)
    monkeypatch.setattr(tst, "mean_of_sum", lambda gsum, n: gsum)
    bundle = _port_bundle("llama3.2-1b", jconfigs.ShapeSpec("t", S, B, "train"), one_rank, 2)
    placed = bundle.lm.policy.param_shardings(params_from_jax(params, "cpu", torch.float32))
    _, _, got = bundle.fn(placed, adamw_init(placed), _tbatch(batch))
    assert _close(float(_full(got["loss"])), want["loss"], LOSS_TOL)
    assert _close(float(_full(got["grad_norm"])), 2 * want["grad_norm"], GNORM_TOL)
    assert not _close(float(_full(got["grad_norm"])), want["grad_norm"], GNORM_TOL)


def test_reference_accum_xent_is_total_loss_pinned():
    """The reference's accum > 1 step reports its total loss, aux term
    included, as ``xent`` (its steps.py:172); at accum 1 the two differ by
    0.01 x moe_aux. The port reports the mean cross-entropy at both."""
    one, _, _ = _ref_train("granite-moe-1b-a400m", 1)
    two, _, _ = _ref_train("granite-moe-1b-a400m", 2)
    assert one["moe_aux"] > 0 and two["moe_aux"] > 0
    assert two["xent"] == two["loss"]
    assert _close(one["loss"] - one["xent"], 0.01 * one["moe_aux"], 1e-4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-medium"])
def test_prefill_matches_reference(arch, one_rank):
    params, batch = _inputs(arch, "prefill")
    shape = jconfigs.ShapeSpec("p", S, B, "prefill")
    want = np.asarray(_ref_bundle(arch, shape).jitted()(
        jax.tree.map(jnp.asarray, params), _jbatch(batch)), np.float32)
    bundle = _port_bundle(arch, shape, one_rank)
    assert not bundle.lm.remat
    placed = bundle.lm.policy.param_shardings(params_from_jax(params, "cpu", torch.float32))
    got = _full(bundle.fn(placed, _tbatch(batch)))
    assert got.shape == want.shape == (B, S, _jcfg(arch).vocab_size)
    assert _rel(got, want) <= LOGITS_TOL


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-medium"])
def test_decode_matches_reference(arch, one_rank):
    """Three decode steps from the zero cache ``decode_init`` lays out
    (the reference's cross cache stays zero; so does the port's here)."""
    params, _ = _inputs(arch, "prefill")
    shape = jconfigs.ShapeSpec("d", S, B, "decode")
    ref = _ref_bundle(arch, shape)
    bundle = _port_bundle(arch, shape, one_rank)
    assert bundle.donate_argnums == (1,)
    step = ref.jitted()
    jp = jax.tree.map(jnp.asarray, params)
    jcache = ref.lm.decode_init(B, S)
    placed = bundle.lm.policy.param_shardings(params_from_jax(params, "cpu", torch.float32))
    cache = bundle.lm.decode_init(B, S)
    fed = np.random.default_rng(11).integers(0, _jcfg(arch).vocab_size, (3, B))
    for pos, toks in enumerate(fed):
        want, jcache = step(jp, jcache, jnp.asarray(toks, jnp.int32), jnp.int32(pos))
        got, cache = bundle.fn(placed, cache, torch.from_numpy(toks), torch.tensor(pos))
        assert _rel(_full(got), np.asarray(want, np.float32)) <= LOGITS_TOL, pos
    for k, t in _flat(cache).items():
        w = np.asarray(functools.reduce(lambda d, p: d[p], k.split("/"), jcache), np.float32)
        assert _rel(_full(t), w) <= LOGITS_TOL, k


def test_train_step_on_two_gloo_ranks(tmp_path, one_rank):
    """The train kind at accum 2 on reduced llama3.2-1b, data 1 x model 2
    on spawned gloo ranks, against the port's own bundle at 1 x 1."""
    arch = "llama3.2-1b"
    lm = TLM(_tcfg(arch), device="cpu")
    params = lm.init(5, param_dtype=torch.float32)
    _, batch = _inputs(arch, "train")
    tb = _tbatch(batch)
    np.savez(tmp_path / "in.npz", **batch,
             **{f"param/{k}": v.numpy() for k, v in _flat(params).items()})
    copy = {k: v.clone() for k, v in _flat(params).items()}
    want, want_state = steps_worker.train_once(one_rank, arch, 2,
                                               steps_worker.unflatten(copy), tb)
    out = steps_worker.spawn(tmp_path, (1, 2), arch, 2)
    with np.load(out) as f:
        got = {k[7:]: float(f[k]) for k in f.files if k.startswith("metric/")}
        got_state = {k: f[k] for k in f.files if not k.startswith("metric/")}
    assert set(got) == set(want)
    for k in ("loss", "xent", "grad_norm"):
        assert _close(got[k], want[k], TP_TOL), (k, got, want)
    steps_worker.hold_update(got_state, {k: v.numpy() for k, v in want_state.items()},
                 {k: v.numpy() for k, v in _flat({"param": params}).items()}, TP_TOL)
