"""The port's examples (``repro_torch.examples``) against the reference's
``examples/``, on the CPU.

The reference examples run only as subprocesses, each with an environment
of its own: ``examples/quickstart.py`` sets ``XLA_FLAGS`` when it is
imported, which must not reach this process or the subprocesses of other
tests. ``serve_stepped`` is held in-process against the reference's stepped
loop, with the reference's params carried over by ``params_from_jax``; f32,
tolerance 1e-4.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402, F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.examples import serve_batch  # noqa: E402
from repro_torch.examples.serve_batch import serve_stepped  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch.serve import make_prompts  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# the card phases' checks, rehearsed here on the CPU
from chip_smoke import (  # noqa: E402
    flash_want,
    quickstart_gather_checks,
    stepped_agree,
    stepped_checks,
)

TOL = 1e-4
CPU = torch.device("cpu")
# the quickstart line whose wording differs: the reference's 16 jax devices
# are the port's 16 ranks stacked in one tensor
EXECUTED = re.compile(r"executed on 16 (?:jax devices|stacked ranks on cpu): NPU (\d+) "
                      r"gathered (\[[^]]*\]) \(group (\[[^]]*\])\), non-member NPU 1 got "
                      r"(\[[^]]*\])$")


def _run(args, **env):
    """stdout of ``python args`` from the repo's root, in an environment of
    its own: PYTHONPATH=src, the CPU for jax, a fixed hash seed."""
    keep = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LANG", "LD_LIBRARY_PATH")
            if k in os.environ}
    got = subprocess.run(
        [sys.executable, *args], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**keep, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
             "PYTHONHASHSEED": "0", "OMP_NUM_THREADS": "1", **env})
    assert got.returncode == 0, got.stderr[-2000:]
    return got.stdout


def test_synthesize_pod_prints_the_reference_lines():
    want = _run(["examples/synthesize_pod.py"])
    got = _run(["-m", "repro_torch.examples.synthesize_pod"])
    assert "out-of-group NPUs carrying traffic" in want
    assert got == want


def test_quickstart_prints_the_reference_lines():
    want = _run(["examples/quickstart.py"],
                XLA_FLAGS="--xla_force_host_platform_device_count=16").splitlines()
    got = _run(["-m", "repro_torch.examples.quickstart", "--device", "cpu"]).splitlines()
    assert len(got) == len(want)
    executed = [i for i, line in enumerate(want) if line.startswith("executed on")]
    assert len(executed) == 1, "the reference skipped its execution"
    (i,) = executed
    assert got[:i] == want[:i] and got[i + 1:] == want[i + 1:]
    assert "stacked ranks on cpu" in got[i]
    numbers = EXECUTED.match(got[i]).groups()
    assert numbers == EXECUTED.match(want[i]).groups()
    assert numbers == ("0", "[1.0, 4.0, 13.0]", "[0, 3, 12]", "[0.0, 0.0, 0.0]")


def _shape(line: str) -> str:
    """A printed line with its times, rates and token ids taken out."""
    line = re.sub(r"in \d+\.\d+s", "in Ts", line)
    line = re.sub(r"\([\d,]+ tok/s\)", "(R tok/s)", line)
    return re.sub(r"\[([\d, ]*)\]",
                  lambda m: "[" + ", ".join("i" for _ in m[1].split(",")) + "]", line)


def test_serve_batch_prints_the_reference_lines(capsys):
    args = ["--batch", "3", "--prompt-len", "6", "--new-tokens", "12"]
    want = _run(["examples/serve_batch.py", *args]).splitlines()
    assert serve_batch.main([*args, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == "serving reduced llama3.2-1b: 0.4M params"
    assert [_shape(line) for line in got] == [_shape(line) for line in want]
    assert _shape(got[2]) == "decode: 12 tokens x 3 seqs in Ts (R tok/s)"
    assert _shape(got[3]) == "  seq 0: [" + ", ".join(["i"] * 10) + "] ..."


def _reference_stepped(jlm, jparams, prompts: np.ndarray, new_tokens: int) -> dict:
    """``examples/serve_batch.py``'s loop on the reference's LM: decode_step
    over the prompt from an f32 cache, then greedy decode."""
    B, S = prompts.shape
    max_seq = S + new_tokens
    cache = jlm.decode_init(B, max_seq, dtype=jnp.float32)
    step = jax.jit(jlm.decode_step)
    steps = []
    for t in range(S):
        logits, cache = step(jparams, cache, jnp.asarray(prompts[:, t]), jnp.asarray(t))
        steps.append(np.asarray(logits))
    tokens = jnp.argmax(logits, axis=-1)
    generated = [np.asarray(tokens)]
    for t in range(S, max_seq - 1):
        logits, cache = step(jparams, cache, tokens, jnp.asarray(t))
        steps.append(np.asarray(logits))
        tokens = jnp.argmax(logits, axis=-1)
        generated.append(np.asarray(tokens))
    return {"tokens": torch.from_numpy(np.stack(generated, 1).astype(np.int64)),
            "logits": torch.from_numpy(np.stack(steps, 1))}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m", "mamba2-370m"])
def test_serve_stepped_matches_reference(arch):
    """Every step's logits within 1e-4 of the reference's stepped loop on
    the same params and prompts, and the same greedy tokens (a token may
    differ only at a near-tie of the reference's top two logits). In the
    moe family this stepping, not the one-pass prefill, is the reference's
    serving."""
    jcfg = jget_config(arch).reduced(dtype="float32")
    jlm = JLM(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    tlm = TLM(tget_config(arch).reduced(dtype="float32"), device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    B, S, n = 2, 7, 5
    prompts = make_prompts(B, S, jcfg.vocab_size, serve_batch.PROMPT_SEED)
    want = _reference_stepped(jlm, jparams, prompts, n)
    tfa.flash_attention.launches = 0
    got = serve_stepped(tlm, tparams, torch.from_numpy(prompts), n)
    assert tfa.flash_attention.launches == 0
    assert got["tokens"].shape == want["tokens"].shape == (B, n)
    assert got["logits"].shape == want["logits"].shape == (B, S + n - 1, jcfg.vocab_size)
    assert got["logits"].dtype == torch.float32
    err, ok, first = stepped_agree(got, want, S, TOL)
    assert ok, (err, first)


def test_serve_stepped_counts_the_reference_steps():
    """``new_tokens`` tokens from S prompt steps and ``new_tokens - 1``
    decode steps: one token and no decode step at ``new_tokens = 1``."""
    lm = TLM(tget_config("llama3.2-1b").reduced(dtype="float32"), device="cpu")
    params = lm.init(serve_batch.WEIGHT_SEED)
    prompts = torch.from_numpy(make_prompts(2, 5, 512, serve_batch.PROMPT_SEED))
    for n in (1, 3):
        out = serve_stepped(lm, params, prompts, n)
        assert out["tokens"].shape == (2, n) and out["logits"].shape == (2, 5 + n - 1, 512)
        assert torch.equal(out["tokens"][:, 0], out["logits"][:, 4].argmax(-1))
        assert torch.equal(out["tokens"][:, 1:], out["logits"][:, 5:].argmax(-1))
    # the cache is f32 whatever the config's dtype, as the reference's
    bf16 = TLM(tget_config("llama3.2-1b").reduced(), device="cpu")
    out = serve_stepped(bf16, bf16.init(0), prompts, 2)
    assert out["logits"].dtype == torch.float32 and torch.isfinite(out["logits"]).all()


def test_stepped_agree_allows_only_near_ties():
    logits = torch.zeros((1, 4, 3))
    logits[0, 2] = torch.tensor([1.0, 1.0 - 1e-5, 0.0])  # a near-tie at the last prompt step
    logits[0, 3] = torch.tensor([0.0, 0.0, 2.0])
    want = {"tokens": torch.tensor([[0, 2]]), "logits": logits}
    got = {"tokens": torch.tensor([[1, 0]]), "logits": logits + 1e-6}
    assert stepped_agree(got, want, 3, TOL)[1:] == (True, 0)
    far = logits.clone()
    far[0, 2, 1] = 0.5
    assert not stepped_agree({"tokens": got["tokens"], "logits": far + 1e-6},
                             {"tokens": want["tokens"], "logits": far}, 3, TOL)[1]
    off = {"tokens": want["tokens"], "logits": logits + 1e-2}
    assert not stepped_agree(off, want, 3, TOL)[1]


def test_chip_quickstart_gather_checks_on_cpu(capsys):
    """The card phase's All-Gather checks on 16 ranks stacked on the CPU:
    NPU 0 gathers [1, 4, 13], bit for bit, and the dropped last round
    fails."""
    quickstart_gather_checks(torch, CPU)
    out = capsys.readouterr().out
    assert "NPU 0 gathered [1.0, 4.0, 13.0]" in out and "check fails as it must" in out


def test_chip_stepped_checks_on_cpu(capsys):
    """The card phase's stepped-serving checks at a reduced f32 llama on the
    CPU (no flash launch on either path here): the stepped prefill holds to
    the one-pass one, and the prompt stepped at shifted positions fails."""
    cfg = tget_config("llama3.2-1b").reduced(dtype="float32")
    lm = TLM(cfg, device="cpu")
    params = lm.init(0)
    prompts = torch.from_numpy(make_prompts(2, 16, cfg.vocab_size, serve_batch.PROMPT_SEED))
    res = stepped_checks(cfg, lm, params, prompts, 4, 1e-3, flash_want(tfa), fault=True)
    assert res["rel_last"] <= TOL and res["rel_all"] <= TOL
    out = capsys.readouterr().out
    fault = re.search(r"planted fault .*every prompt step rel_l2=([\d.e+-]+)", out)
    assert float(fault[1]) > 1e-3
