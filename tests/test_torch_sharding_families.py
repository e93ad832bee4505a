"""``LM(policy=)`` at model > 1 for the ssm, hybrid and encdec families
against the JAX package, on gloo ranks on the CPU.

One spawn a mesh (data x model = 1 x 2, 1 x 4, 2 x 2; ``tests/_torch_tp_worker.py``,
``file://`` rendezvous under tmp): reduced mamba2-370m (8 SSD heads, 4 or 2
a rank), zamba2-7b at 5 layers (2 groups of 2 Mamba blocks, each with the
shared attention block, then a tail block), whisper-medium (8 frames: the
cross cache splits on sequence at model 2 and 4; 2 KV heads, replicated at
model 4) and, at 1 x 4, mamba2-370m with 6 SSD heads of 64 (d_inner 384),
whose d_inner leaves split over 4 ranks and whose per-head leaves do not,
so every rank runs every head. At 2 x 2 whisper also at batch 1, both its
caches split on sequence over all four ranks. B 2, S 16 and 8 fed tokens,
so that S and S + 8 are multiples of the chunk of 8 and the state crosses
two and three chunks; A_log and dt_bias set to slow, per-head distinct
decays in both packages' params (at the reference's init a token forgets
the state before the next chunk).

Held, f32, against the reference on one device (``LM(cfg,
use_flash=True)``, its Pallas kernel in interpret mode): prefill logits,
the logits at each fed token (its ``forward_logits`` over prompt + fed
tokens), the loss and every gradient leaf (``jax.value_and_grad`` of
``LM(cfg).loss``), rel-L2 1e-4; every gathered cache leaf against the
port's unsharded prefill + decode. A planted fault (the gated norm's mean
of squares over a rank's own channels) must fail the ssm case at 1 x 2.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402, F401
import _torch_tp_worker as tp_worker  # noqa: E402
import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402

REL_TOL = 1e-4
# the gathered caches against the unsharded port: 1e-6, but for the hybrid's
# tail block, the deepest, whose state and windows read 1.2-1.5e-6 at 1 x 2:
# the row-parallel out_proj and wo products add their ranks' partial sums in
# another order than one GEMM does, a few 1e-7 a block, which five random
# blocks compound (the gated norm's sum order is not it: a mean over the
# gathered squares reads the same)
CACHE_TOL = 1e-6
TAIL_CACHE_TOL = 2e-6
CASES = {  # name: (arch, overrides of its reduced f32 config)
    "ssm": ("mamba2-370m", dict(ssm_chunk=8)),
    "hybrid": ("zamba2-7b", dict(num_layers=5, ssm_chunk=8)),
    "encdec": ("whisper-medium", {}),
    "ssm_mixed": ("mamba2-370m", dict(ssm_chunk=8, ssm_expand=3, ssm_head_dim=64)),
    "encdec_batch1": ("whisper-medium", {}),
}
RUNS = {  # mesh: the cases run there
    (1, 2): ["ssm", "hybrid", "encdec"],
    (1, 4): ["ssm", "hybrid", "encdec", "ssm_mixed"],
    (2, 2): ["ssm", "hybrid", "encdec", "encdec_batch1"],
}
FAULT = ((1, 2), "ssm")  # the planted local mean runs here as "ssm_local_mean"
B, S, FED = 2, 16, 8


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _slow_decays(params: dict) -> dict:
    """Every Mamba block's A_log and dt_bias [L, H] set to slow decays,
    distinct by head and by layer: A = -(0.05 .. 0.5), dt_bias -4 .. -2."""
    flat = tp_worker.flatten(params)
    for key, v in flat.items():
        if key.endswith(("/A_log", "/dt_bias")):
            L, H = v.shape
            lo, hi = (np.log(0.05), np.log(0.5)) if key.endswith("A_log") else (-4.0, -2.0)
            heads = np.linspace(lo, hi, H)[None, :]
            flat[key] = (heads + 0.1 * np.arange(L)[:, None]).astype(np.float32)
    return tp_worker.unflatten(flat)


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """The case's params (numpy, slow decays), inputs and the reference's
    results: prefill logits (the last prompt position of
    ``forward_logits``), the logits at each fed token (``forward_logits``
    over prompt + fed tokens), the loss and every gradient leaf."""
    arch, over = CASES[name]
    cfg = jget_config(arch).reduced(dtype="float32", **over)
    rng = np.random.default_rng(7)
    batch = 1 if name.endswith("batch1") else B
    tokens = rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)
    fed = rng.integers(0, cfg.vocab_size, (batch, FED)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)
    stub = {}
    if cfg.family == "encdec":
        stub["frames"] = rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)
                                             ).astype(np.float32)
    jlm = JLM(cfg, use_flash=True)
    params = _slow_decays(jax.tree.map(np.asarray, jax.jit(jlm.init)(jax.random.PRNGKey(0))))
    fwd = jax.jit(jlm.forward_logits)
    out = {"prefill": np.asarray(fwd(params, {"tokens": tokens, **stub}))[:, -1]}
    longer = np.asarray(fwd(params, {"tokens": np.concatenate([tokens, fed], 1), **stub}))
    for i in range(FED):
        out[f"decode{i}"] = longer[:, S + i]
    (loss, _), grads = jax.jit(jax.value_and_grad(JLM(cfg).loss, has_aux=True))(
        params, {"tokens": tokens, "labels": labels, **stub})
    out["loss"] = np.asarray(loss)
    out["grads"] = jax.tree.map(np.asarray, grads)
    return params, {"tokens": tokens, "fed": fed, "labels": labels, **stub}, out


def _case(tmp, name: str, run_as: str | None = None, **extra) -> dict:
    params, inputs, _ = _reference(name)
    np.savez(tmp / f"{name}.npz", **inputs,
             **{f"param/{k}": v for k, v in tp_worker.flatten(params).items()})
    arch, over = CASES[name]
    return {"name": run_as or name, "arch": arch, "over": over, "inputs": name, **extra}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's run: {(data, model): rank 0's output dir}."""
    out = {}
    for shape, names in RUNS.items():
        tmp = tmp_path_factory.mktemp(f"tp{shape[0]}x{shape[1]}")
        cases = [_case(tmp, name) for name in names]
        if shape == FAULT[0]:
            cases.append(_case(tmp, FAULT[1], run_as=f"{FAULT[1]}_local_mean",
                               fault="local_mean"))
        out[shape] = tp_worker.spawn(tmp, shape, cases)
    return out


def _got(runs, shape, name) -> dict:
    with np.load(runs[shape] / f"{name}.npz") as f:
        return {k: f[k] for k in f.files}


RUN_IDS = [(shape, name) for shape, names in RUNS.items() for name in names]


@pytest.mark.parametrize("shape,name", RUN_IDS,
                         ids=[f"{s[0]}x{s[1]}-{n}" for s, n in RUN_IDS])
def test_tensor_parallel_matches_reference(runs, shape, name):
    """Prefill logits, the logits at 8 fed tokens, the loss and every
    gradient leaf of the policy LM on the gloo ranks against the
    reference, rel-L2 1e-4."""
    _, _, want = _reference(name)
    got = _got(runs, shape, name)
    for key in ["prefill"] + [f"decode{i}" for i in range(FED)] + ["loss"]:
        assert _rel(got[key], want[key]) <= REL_TOL, (key, _rel(got[key], want[key]))
    leaves = tp_worker.flatten(want["grads"])
    assert {k[5:] for k in got if k.startswith("grad/")} == set(leaves)
    for key, w in leaves.items():
        assert _rel(got[f"grad/{key}"], w) <= REL_TOL, (key, _rel(got[f"grad/{key}"], w))


@functools.lru_cache(maxsize=None)
def _unsharded_cache(name: str) -> dict:
    """The port's cache after prefill + the fed decode steps, no policy."""
    params, inputs, _ = _reference(name)
    arch, over = CASES[name]
    lm = TLM(tget_config(arch).reduced(dtype="float32", **over), device="cpu")
    tparams = params_from_jax(params, "cpu", torch.float32)
    stub = {k: torch.from_numpy(inputs[k]) for k in ("frames",) if k in inputs}
    fed = torch.from_numpy(inputs["fed"])
    with torch.no_grad():
        _, cache = lm.prefill(tparams, torch.from_numpy(inputs["tokens"]), max_seq=S + FED,
                              **stub)
        for i in range(FED):
            lm.decode_step(tparams, cache, fed[:, i], S + i)
    return {k: v.numpy() for k, v in tp_worker.flatten(cache).items()}


@pytest.mark.parametrize("shape,name", RUN_IDS,
                         ids=[f"{s[0]}x{s[1]}-{n}" for s, n in RUN_IDS])
def test_gathered_cache_matches_the_unsharded_one(runs, shape, name):
    """Every leaf of the cache that the policy's prefill and decode wrote
    (the SSM state and conv windows split on heads and channels, the KV
    cache, the cross cache split on sequence), gathered, against the same
    steps without a policy."""
    want = _unsharded_cache(name)
    got = _got(runs, shape, name)
    assert {k[6:] for k in got if k.startswith("cache/")} == set(want)
    for key, w in want.items():
        tol = TAIL_CACHE_TOL if key.startswith("ssm_tail/") else CACHE_TOL
        assert _rel(got[f"cache/{key}"], w) <= tol, (key, _rel(got[f"cache/{key}"], w))


def test_gated_norm_local_mean_is_caught(runs):
    """Planted fault: each rank's gated RMSNorm over its own half of
    d_inner instead of the whole. The ssm case at 1 x 2 must miss the
    reference's logits."""
    _, _, want = _reference(FAULT[1])
    got = _got(runs, FAULT[0], f"{FAULT[1]}_local_mean")
    assert _rel(got["prefill"], want["prefill"]) > 100 * REL_TOL
