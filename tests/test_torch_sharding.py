"""The port's meshes, ``ShardingPolicy``, ``pad_heads`` and ``LM(policy=)``
against the JAX package's, on the CPU.

Specs: the reference's ``ShardingPolicy`` reads only its mesh's axis names
and ``devices`` shape, so a stand-in mesh gives it a production mesh's
specs without 256 devices, leaf by leaf of ``jax.eval_shape(lm.init)`` at
full width. Tensor parallelism: gloo ranks spawned with a ``file://``
rendezvous under ``tmp_path`` (no TCP port), each run joined under a time
limit; the reduced dense, moe and vlm configs, f32, against the
reference's ``LM(cfg, use_flash=True)`` (its Pallas kernel in interpret
mode) for logits and ``jax.value_and_grad`` of ``LM(cfg).loss`` (the
kernel has no VJP) for the loss and every gradient leaf, by rel-L2 1e-4.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402, F401
import _torch_tp_worker as tp_worker  # noqa: E402
import jax  # noqa: E402

from repro.configs import REGISTRY  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    head_positions,
    pad_head_params,
    params_from_jax,
    params_to_numpy,
)
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch.serve import make_prompts  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402

REL_TOL = 1e-4
ARCHS = sorted(REGISTRY)
MESHES = {  # name: (axis names, sizes)
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "2x4": (("data", "model"), (2, 4)),
    "1x4": (("data", "model"), (1, 4)),
    "2x2x2": (("pod", "data", "model"), (2, 2, 2)),
}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_meshes_carry_the_references_names_and_sizes():
    assert tmesh.make_production_mesh().axis_sizes == {"data": 16, "model": 16}
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model") and multi.shape == (2, 16, 16)
    assert multi.size == 512 and multi.device_type == "cuda"
    test = tmesh.make_test_mesh(device_type="cpu")
    assert test.axis_names == ("data", "model") and test.shape == (2, 4)
    assert tmesh.make_test_mesh(1, 2, pods=2).shape == (2, 1, 2)
    assert tmesh.mesh_axis_size(multi, "pod") == 2
    assert tmesh.mesh_axis_size(test, "pod") == 1
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.make_mesh((2, 2), ("data",))
    with pytest.raises(ValueError, match="unsupported device type"):
        tmesh.make_mesh((2,), ("data",), device_type="meta")


def test_device_mesh_needs_a_group_of_its_size_and_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_test_mesh(1, 1).device_mesh  # cuda unless asked: no fallback
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_test_mesh(1, 2, device_type="cpu").device_mesh


# ---------------------------------------------------------------------------
# pad_heads and the specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("arch", ARCHS)
def test_pad_heads_matches_reference(arch, tp):
    want = jsh.pad_heads(jget_config(arch), tp)
    got = tsh.pad_heads(tget_config(arch), tp)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if tp == 16 and arch in ("llava-next-34b", "granite-moe-3b-a800m"):
        assert got.num_heads == {"llava-next-34b": 64, "granite-moe-3b-a800m": 32}[arch]


def _policies(arch: str, mesh: str):
    names, shape = MESHES[mesh]
    tp = dict(zip(names, shape))["model"]
    jcfg = jsh.pad_heads(jget_config(arch), tp)
    ref = jsh.ShardingPolicy(types.SimpleNamespace(axis_names=names,
                                                   devices=np.empty(shape)), jcfg)
    ref.named = lambda spec: spec  # cache_shardings' specs, without a jax mesh
    port = tsh.ShardingPolicy(tmesh.make_mesh(shape, names),
                              tsh.pad_heads(tget_config(arch), tp))
    return ref, port, jcfg, tp


@functools.lru_cache(maxsize=None)
def _shapes(arch: str, tp: int):
    """The reference's full-width param and cache trees as shapes."""
    jcfg = jsh.pad_heads(jget_config(arch), tp)
    lm = JLM(jcfg, ep_degree=tp)
    params = jax.eval_shape(lm.init, jax.random.PRNGKey(0))
    caches = {(b, t): jax.eval_shape(lambda b=b, t=t: lm.decode_init(b, t))
              for b, t in ((1, 4096), (1, 4000), (8, 1024), (6, 512))}
    return params, caches


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, mesh):
    """Every param leaf of the padded config at full width, every cache
    leaf of ``decode_init`` at four (batch, length) pairs, and the batch,
    token, sequence and logits specs."""
    ref, port, jcfg, tp = _policies(arch, mesh)
    params, caches = _shapes(arch, tp)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) > 5
    for path, leaf in leaves:
        names = tuple(k.key for k in path)
        assert port.param_spec(names, leaf) == tuple(ref.param_spec(path, leaf)), names
    for (b, t), cache in caches.items():
        want = jax.tree.map(tuple, ref.cache_shardings(cache, b),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got = port.cache_shardings(jax.tree.map(lambda s: types.SimpleNamespace(
            shape=s.shape), cache), b)
        assert jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple)) == \
            jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple)), (b, t)
        assert port.kv_cache_spec(b, t) == tuple(ref.kv_cache_spec(b, t))
        assert port.batch_spec(b, t) == tuple(ref.batch_spec(b, t))
        assert port.token_spec(b) == tuple(ref.token_spec(b))
        assert port.logits_spec(b) == tuple(ref.logits_spec(b))
    assert port.seq_spec == tuple(ref.seq_spec)
    assert (port.tp, port.tp_size, port.dp, port.dp_size, port.fsdp, port.fsdp_size,
            port.all_axes, port.total) == (ref.tp, ref.tp_size, ref.dp, ref.dp_size,
                                           ref.fsdp, ref.fsdp_size, ref.all_axes, ref.total)


def test_param_specs_keep_the_tree():
    _, port, _, tp = _policies("granite-moe-3b-a800m", "16x16")
    params, _ = _shapes("granite-moe-3b-a800m", tp)
    tree = jax.tree.map(lambda s: types.SimpleNamespace(shape=s.shape), params)
    specs = port.param_specs(tree)
    assert specs["layers"]["moe"]["gate"] == (None, "model", "data", None)  # E 48 on 16
    assert specs["layers"]["attn"]["wk"] == (None, "data", None)  # 8 KV heads on 16
    assert specs["layers"]["attn"]["wq"] == (None, "data", "model")


def test_collective_planner_takes_the_mesh_sizes():
    from repro_torch.topology import torus2d

    port = tsh.ShardingPolicy(tmesh.make_mesh((4, 4), ("data", "model")),
                              tget_config("llama3.2-1b"))
    planner = port.collective_planner(torus2d(4, 4))
    assert isinstance(planner, tsh.MeshCollectivePlanner)
    assert dict(planner.axis_sizes) == {"data": 4, "model": 4}


def test_placements_split_major_to_minor():
    """A dimension over ("pod", "data") splits pod first, as jax's
    PartitionSpec does; DTensor splits on the leftmost mesh axis first, so
    a tuple out of the mesh's order is refused."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    pol = tsh.ShardingPolicy(tmesh.make_mesh((2, 2, 2), ("pod", "data", "model")),
                             tget_config("llama3.2-1b"))
    assert pol.placements(pol.seq_spec) == [Shard(0), Shard(0), Shard(1)]
    assert pol.placements(pol.kv_cache_spec(1, 64)) == [Shard(2)] * 3
    assert pol.placements((None, None), partial=("model",)) == [
        Replicate(), Replicate(), Partial()]
    with pytest.raises(ValueError, match="mesh's order"):
        pol.placements((("data", "pod"), None))
    with pytest.raises(ValueError, match="splits dims"):
        pol.placements(("model", "model"))


# ---------------------------------------------------------------------------
# pad_head_params
# ---------------------------------------------------------------------------

def test_head_positions_keep_each_head_in_its_kv_group():
    pos = head_positions(56, 64, 8)  # llava-next-34b at tp = 16
    assert pos[:7] == list(range(7)) and pos[7] == 8  # group 1 starts at 8
    assert all(p // 8 == h // 7 for h, p in enumerate(pos))
    assert head_positions(24, 32, 8)[3] == 4  # granite-moe-3b-a800m
    with pytest.raises(ValueError):
        head_positions(6, 7, 2)


@pytest.mark.parametrize("H,KV,first,count,want", [
    (4, 2, 3, 1, slice(1, 2)),             # reduced llama at model = 4
    (64, 8, 12, 4, slice(1, 2)),           # llava padded at 16: 4 heads of one group
    (32, 8, 8, 8, slice(2, 4)),            # two whole groups
    (12, 3, 0, 6, [0, 0, 0, 0, 1, 1]),     # uneven: an index a query head
])
def test_local_kv_heads(H, KV, first, count, want):
    from repro_torch.models.attention import local_kv_heads

    assert local_kv_heads(H, KV, first, count) == want


def _padded_pair(seed=0, moe=False):
    arch = "granite-moe-3b-a800m" if moe else "llama3.2-1b"
    cfg = tget_config(arch).reduced(dtype="float32", num_heads=6, num_kv_heads=2)
    padded = tsh.pad_heads(cfg, 4)
    assert padded.num_heads == 8
    ep = 3 if moe else 1
    lm = TLM(cfg, device="cpu")
    plm = TLM(padded, device="cpu", ep_degree=ep)
    params = lm.init(seed, param_dtype=torch.float32)
    return cfg, padded, lm, plm, params, (plm.e_pad if moe else None)


@pytest.mark.parametrize("moe", [False, True])
def test_padded_model_keeps_the_function(moe):
    """The padded model with ``pad_head_params`` equals the unpadded one
    (prefill logits and decode); the reference's layout, pad heads appended
    at the end with zero wo rows, regroups GQA and does not."""
    cfg, padded, lm, plm, params, experts = _padded_pair(moe=moe)
    carried = pad_head_params(params, cfg, padded, experts=experts)
    assert carried["layers"]["attn"]["wq"].shape[-1] == 8 * cfg.head_dim
    if moe:
        assert carried["layers"]["moe"]["gate"].shape[1] == 6
    tokens = torch.from_numpy(make_prompts(2, 12, cfg.vocab_size, 3))
    with torch.no_grad():
        want = lm.forward_logits(params, tokens)
        assert _rel(plm.forward_logits(carried, tokens), want) < 1e-6
        appended = pad_head_params(params, cfg, padded, experts=experts,
                                   positions=list(range(cfg.num_heads)))
        assert _rel(plm.forward_logits(appended, tokens), want) > 1e-2
        _, cache = lm.prefill(params, tokens, max_seq=14)
        _, pcache = plm.prefill(carried, tokens, max_seq=14)
        nxt = want[:, -1].argmax(-1)
        assert _rel(plm.decode_step(carried, pcache, nxt, 12)[0],
                    lm.decode_step(params, cache, nxt, 12)[0]) < 1e-6


def test_reference_pad_heads_init_draws_nonzero_pad_wo_rows():
    """Pinned: the reference's ``pad_heads`` + ``init`` gives its pad heads
    random ``wo`` rows (``attention_init`` draws every head), not the zero
    rows its module docstring says keep the function."""
    cfg = jsh.pad_heads(jget_config("llama3.2-1b").reduced(num_heads=6, num_kv_heads=2), 4)
    assert cfg.num_heads == 8
    params = JLM(cfg).init(jax.random.PRNGKey(0))
    wo = np.asarray(params["layers"]["attn"]["wo"])  # [L, H * hd, d]
    pad_rows = wo[:, 6 * cfg.head_dim:]
    assert np.abs(pad_rows).min() > 0 and np.abs(pad_rows).mean() > 1e-2


# ---------------------------------------------------------------------------
# LM(policy=)
# ---------------------------------------------------------------------------

def test_policy_checks(monkeypatch):
    """The ssm, hybrid and encdec families take a policy at model 1, 2 and
    4; full mamba2-370m (attention-free: ``num_heads`` 1) at model 2 too;
    attention heads (the hybrid's and whisper's included) and experts must
    divide the model axis."""
    mesh = tmesh.make_test_mesh(1, 2, device_type="cpu")
    four = tmesh.make_test_mesh(1, 4, device_type="cpu")
    for arch in ("mamba2-370m", "zamba2-7b", "whisper-medium"):
        cfg = tget_config(arch).reduced()
        for m in (tmesh.make_test_mesh(2, 1, device_type="cpu"), mesh, four):
            assert TLM(cfg, device="cpu", policy=tsh.ShardingPolicy(m, cfg)).policy is not None
    full = tget_config("mamba2-370m")
    assert full.num_heads == 1
    assert TLM(full, device="cpu", policy=tsh.ShardingPolicy(mesh, full)).policy is not None
    for arch in ("llama3.2-1b", "zamba2-7b", "whisper-medium"):
        cfg = tget_config(arch).reduced(num_heads=6, num_kv_heads=2)
        with pytest.raises(ValueError, match="pad_heads"):
            TLM(cfg, device="cpu", policy=tsh.ShardingPolicy(four, cfg))
    cfg = tget_config("llama3.2-1b").reduced(num_heads=6)
    moe = tget_config("granite-moe-3b-a800m").reduced(num_experts=6)
    with pytest.raises(ValueError, match="ep_degree"):
        TLM(moe, device="cpu", policy=tsh.ShardingPolicy(four, moe))
    assert TLM(moe, device="cpu", ep_degree=4, policy=tsh.ShardingPolicy(four, moe)).e_pad == 8
    with pytest.raises(ValueError, match="another config"):
        TLM(cfg, device="cpu", policy=tsh.ShardingPolicy(mesh, tget_config("llama3.2-1b")))
    with pytest.raises(ValueError, match="a cuda mesh"):
        TLM(moe, device="cpu", ep_degree=2,
            policy=tsh.ShardingPolicy(tmesh.make_test_mesh(1, 2), moe))


CASES = {  # name: (arch, overrides of its reduced config, ep_degree from tp)
    "dense": ("llama3.2-1b", {}),
    "moe": ("granite-moe-3b-a800m", {}),
    "vlm": ("llava-next-34b", {}),
}
B, S, FED = 2, 16, 4
PAD_UNPADDED = dict(num_heads=6, num_kv_heads=2)


def _jcfg(arch, over):
    return jget_config(arch).reduced(dtype="float32", **over)


def _reference(name: str, tp: int):
    """The reference's params (numpy) and results for one case at a model
    axis of ``tp``: prefill logits (the last prompt position of
    ``forward_logits``), the logits at each fed token (``forward_logits``
    over prompt + fed tokens, at the no-drop capacity in the moe family),
    the loss, moe_aux and every gradient leaf. Only the moe family's
    padded expert count depends on ``tp``."""
    if name in ("padded", "batch1"):
        arch, over = "llama3.2-1b", PAD_UNPADDED if name == "padded" else {}
    else:
        arch, over = CASES[name]
    cfg = _jcfg(arch, over)
    return _reference_at(name, arch, tuple(sorted(over.items())),
                         cfg.padded_experts(tp) if name == "moe" else 0)


@functools.lru_cache(maxsize=None)
def _reference_at(name: str, arch: str, over: tuple, e_pad: int):
    cfg = _jcfg(arch, dict(over))
    ep = e_pad or 1
    rng = np.random.default_rng(7)
    batch = 1 if name == "batch1" else B
    tokens = rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)
    fed = rng.integers(0, cfg.vocab_size, (batch, FED)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)
    stub = {}
    if cfg.family == "vlm":
        stub["patches"] = rng.standard_normal((batch, cfg.num_patches, cfg.d_model)
                                              ).astype(np.float32)
    jlm = JLM(cfg, ep_degree=ep, use_flash=True)
    params = jax.jit(jlm.init)(jax.random.PRNGKey(0))
    fwd = jax.jit(jlm.forward_logits)
    out = {"prefill": np.asarray(fwd(params, {"tokens": tokens, **stub}))[:, -1]}
    step_lm = JLM(tp_worker.no_drop(cfg), ep_degree=ep, use_flash=True)
    longer = np.asarray(jax.jit(step_lm.forward_logits)(
        params, {"tokens": np.concatenate([tokens, fed], 1), **stub}))
    for i in range(FED):
        out[f"decode{i}"] = longer[:, S + i]
    (loss, metrics), grads = jax.jit(jax.value_and_grad(JLM(cfg, ep_degree=ep).loss,
                                                        has_aux=True))(
        params, {"tokens": tokens, "labels": labels, **stub})
    out["loss"], out["moe_aux"] = np.asarray(loss), np.asarray(metrics["moe_aux"])
    out["grads"] = jax.tree.map(np.asarray, grads)
    inputs = {"tokens": tokens, "fed": fed, "labels": labels, **stub}
    return jax.tree.map(np.asarray, params), inputs, out


def _save_inputs(tmp_path, name: str, tp: int, params) -> str:
    _, inputs, _ = _reference(name, tp)
    flat = tp_worker.flatten(params)
    np.savez(tmp_path / f"{name}.tp{tp}.npz", **inputs,
             **{f"param/{k}": v for k, v in flat.items()})
    return f"{name}.tp{tp}"


def _padded_params(jparams):
    cfg = tget_config("llama3.2-1b").reduced(dtype="float32", **PAD_UNPADDED)
    padded = tsh.pad_heads(cfg, 4)
    tree = params_from_jax(jparams, "cpu", torch.float32)
    return params_to_numpy(pad_head_params(tree, cfg, padded)), cfg, padded


TP_MESHES = [(1, 2), (1, 4), (2, 2)]


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every mesh's run: {(data, model): output dir}."""
    runs = {}
    for shape in TP_MESHES:
        tmp = tmp_path_factory.mktemp(f"tp{shape[0]}x{shape[1]}")
        tp = shape[1]
        cases = []
        for name, (arch, over) in CASES.items():
            params, _, _ = _reference(name, tp)
            cases.append({"name": name, "arch": arch, "over": over,
                          "ep": tp if name == "moe" else 1,
                          "inputs": _save_inputs(tmp, name, tp, params)})
        if shape == (1, 4):
            params, _, _ = _reference("padded", 4)
            padded_np, _, padded = _padded_params(params)
            cases.append({"name": "padded", "arch": "llama3.2-1b",
                          "over": dict(num_heads=padded.num_heads, num_kv_heads=2),
                          "inputs": _save_inputs(tmp, "padded", 4, padded_np)})
        if shape == (2, 2):
            params, _, _ = _reference("batch1", 2)
            cases.append({"name": "batch1", "arch": "llama3.2-1b", "over": {},
                          "inputs": _save_inputs(tmp, "batch1", 2, params)})
            cases.append({"name": "aligned_moe"})
        runs[shape] = tp_worker.spawn(tmp, shape, cases)
    return runs


def _unpad_grad(key: str, g: np.ndarray, cfg) -> np.ndarray:
    """A padded model's gradient leaf restricted to the real heads."""
    hd = cfg.head_dim
    cols = (np.asarray(head_positions(6, 8, 2))[:, None] * hd + np.arange(hd)).reshape(-1)
    if key.endswith("attn/wq"):
        return g[..., cols]
    if key.endswith("attn/wo"):
        return g[..., cols, :]
    return g


TP_CASES = [(shape, name) for shape in TP_MESHES for name in CASES] + [
    ((1, 4), "padded"),  # 6 heads, 2 KV heads, padded to 8 at model = 4
    ((2, 2), "batch1"),  # one sequence: its cache splits over all four ranks
]


@pytest.mark.parametrize("shape,name", TP_CASES, ids=[f"{s[0]}x{s[1]}-{n}" for s, n in TP_CASES])
def test_tensor_parallel_matches_reference(tp_runs, shape, name):
    """Prefill logits, decode logits at 4 fed tokens, the loss and every
    gradient leaf of the policy LM on the gloo ranks against the
    reference, rel-L2 1e-4."""
    tp = shape[1]
    _, _, want = _reference(name, tp)
    with np.load(tp_runs[shape] / f"{name}.npz") as f:
        got = {k: f[k] for k in f.files}
    for key in ["prefill"] + [f"decode{i}" for i in range(FED)] + ["loss", "moe_aux"]:
        assert _rel(got[key], want[key]) <= REL_TOL, (key, _rel(got[key], want[key]))
    cfg = _jcfg("llama3.2-1b", PAD_UNPADDED)
    leaves = tp_worker.flatten(want["grads"])
    assert {k[5:] for k in got if k.startswith("grad/")} == set(leaves)
    for key, w in leaves.items():
        g = got[f"grad/{key}"]
        if name == "padded":
            if key.endswith("attn/wq"):  # the pad heads' columns take no gradient
                assert not g[..., np.setdiff1d(np.arange(g.shape[-1]),
                                               _unpad_grad(key, np.arange(g.shape[-1]),
                                                           cfg))].any()
            g = _unpad_grad(key, g, cfg)
        assert _rel(g, w) <= REL_TOL, (key, _rel(g, w))


def test_tensor_parallel_cache_matches_the_unsharded_prefill(tp_runs):
    """The KV cache the policy's prefill and decode wrote, gathered, equals
    the cache of the same steps without a policy (the dense case on each
    mesh, and batch 1 whose cache splits its sequence over all four
    ranks)."""
    for shape, name in [*((s, "dense") for s in TP_MESHES), ((2, 2), "batch1")]:
        params, inputs, _ = _reference(name, shape[1])
        cfg = tget_config("llama3.2-1b").reduced(dtype="float32")
        lm = TLM(cfg, device="cpu")
        tparams = params_from_jax(params, "cpu", torch.float32)
        tokens, fed = torch.from_numpy(inputs["tokens"]), torch.from_numpy(inputs["fed"])
        with torch.no_grad():
            _, cache = lm.prefill(tparams, tokens, max_seq=S + FED)
            for i in range(FED):
                lm.decode_step(tparams, cache, fed[:, i], S + i)
        with np.load(tp_runs[shape] / f"{name}.npz") as f:
            assert _rel(f["cache/kv/k"], cache["kv"]["k"].numpy()) <= 1e-6, (shape, name)


def test_moe_ranks_holding_whole_routing_groups(tp_runs):
    """At data = 2, 2 x 1024 tokens: each rank routes its own groups of
    1024 and the aux loss adds the router sums over ranks; loss, aux and
    every gradient leaf as without a policy."""
    with np.load(tp_runs[(2, 2)] / "aligned_moe.npz") as f:
        assert _rel(f["loss"], f["want"]) <= 1e-6
        assert _rel(f["aux"], f["want_aux"]) <= 1e-6
        assert float(f["worst"]) <= REL_TOL
