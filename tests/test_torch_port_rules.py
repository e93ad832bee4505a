"""Rules the port keeps: it imports nothing of jax or of the JAX package,
runs on the card unless asked for the CPU, and has no fallback when the
card's pieces (CUDA, nvcc) are missing."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "transformer.py", "ops.py", "serve.py", "ssm.py",
            "ssd_scan.py", "mamba2_370m.py"} <= names
    rel = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES[:-1]}
    assert {f"core/{m}.py" for m in COPIED["core"]} <= rel
    assert {f"topology/{m}.py" for m in COPIED["topology"]} <= rel
    assert {"core/__init__.py", "topology/__init__.py", "comms/__init__.py",
            "comms/executor.py", "comms/primitives.py", "comms/selftest.py"} <= rel


# the planner modules the port copies from the reference, by package
COPIED = {
    "topology": ("topology", "generators"),
    "core": ("errors", "conditions", "request", "algorithm", "ten", "pathfinding",
             "registry", "serialize", "translate", "traffic", "hierarchy", "engine"),
}
FIX_BEGIN, FIX_END = "# >>> copy fix: _store_disk race", "# <<< copy fix"


def _normalised(text: str) -> list[str]:
    """Lines with the package name of import lines made the reference's."""
    out = []
    for line in text.splitlines():
        stripped = line.lstrip()
        if stripped.startswith(("from repro_torch", "import repro_torch")):
            line = line.replace("repro_torch", "repro", 1)
        out.append(line)
    return out


def _cut(lines: list[str], first: str, last: str) -> tuple[list[str], list[str]]:
    """(lines without the span from the line holding ``first`` to the line
    holding ``last``, both included; the span)."""
    i = next(k for k, line in enumerate(lines) if first in line)
    j = next(k for k, line in enumerate(lines) if k >= i and last in line)
    return lines[:i] + lines[j + 1:], lines[i:j + 1]


@pytest.mark.parametrize("rel", [f"{pkg}/{m}.py" for pkg, mods in COPIED.items()
                                 for m in mods])
def test_planner_copy_does_not_drift(rel):
    """A copied module equals the reference's but for its import lines and
    the one marked fix: the copy cannot drift silently."""
    port = _normalised((ROOT / "src" / "repro_torch" / rel).read_text())
    ref = (ROOT / "src" / "repro" / rel).read_text().splitlines()
    if rel != "core/registry.py":
        assert not any(FIX_BEGIN in line for line in port)
        assert port == ref
        return
    port, fix = _cut(port, FIX_BEGIN, FIX_END)
    # the fix replaces the reference's lines from the temporary name to the
    # size taken after the rename
    ref, replaced = _cut(ref, 'tmp = f"{path}.tmp.{os.getpid()}"',
                         "self.stats.bytes_stored += os.path.getsize(path)")
    assert port == ref
    assert any("os.path.getsize(tmp)" in line for line in fix)
    assert any("threading.get_ident()" in line for line in fix)
    assert len(replaced) == 12


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_needs_cuda_unless_cpu(no_cuda):
    for asked in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(asked)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_raise_without_cuda(no_cuda):
    for arch in ("llama3.2-1b", "mamba2-370m"):
        with pytest.raises(RuntimeError, match="CUDA"):
            LM(get_config(arch).reduced())
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", arch, "--reduced", "--prompt-len", "4",
                        "--new-tokens", "1"])


def test_serve_runs_on_cpu_when_asked(capsys):
    for arch in ("llama3.2-1b", "mamba2-370m"):
        assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8",
                           "--new-tokens", "3"]) == 0
        out = capsys.readouterr().out
        assert f"serving {arch}" in out
        assert "prefill: 2x8 tokens" in out and "decode: 3 steps x 2 seqs" in out


def test_registry_holds_only_ported_archs():
    assert get_config("llama3.2-1b").family == "dense"
    assert get_config("mamba2-370m").family == "ssm"
    with pytest.raises(KeyError, match="not yet ported"):
        get_config("zamba2-7b")


def test_other_families_not_ported():
    cfg = get_config("llama3.2-1b").reduced()
    for fam in ("moe", "hybrid", "encdec", "vlm"):
        with pytest.raises(NotImplementedError):
            LM(cfg.reduced(family=fam), device="cpu")


def test_builder_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "CUDA_HOMES", (str(tmp_path),))
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build_all()
    for name in build.SOURCES:
        with pytest.raises(build.KernelBuildError):
            build.load(name)


def test_builder_raises_with_nvcc_output(monkeypatch, tmp_path):
    """A refused source raises with what nvcc said, and leaves no library."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: sm_90a refused' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(build.KernelBuildError, match="sm_90a refused"):
        build.build_all()
    assert not list((tmp_path / "out").glob("*.so"))


def test_build_target_follows_source_hash(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// one")
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build._target("k")[1]
    (csrc / "k.cu").write_text("// two")
    assert build._target("k")[1] != first
    assert first.parent == build.BUILD_DIR


def test_trace_needs_cuda_and_sums_busy_time(no_cuda):
    from repro_torch.launch import trace

    with pytest.raises(RuntimeError, match="CUDA"):
        trace.main()
    assert trace._busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert trace._busy_us([]) == 0
    assert trace.kind_of("void (anonymous namespace)::ssd_chunk_out_kernel<64, 128>("
                         "(anonymous namespace)::Params, int)") == "ssd_scan"
    assert trace.kind_of("sm90_xmma_gemm_bf16bf16_bf16f32") == "matmul"
    assert trace.kind_of("vectorized_elementwise_kernel") == "other"


def test_trace_takes_a_dtype(no_cuda):
    """--dtype float32 traces llama as chip_smoke.py serves it in f32 (the
    mma route); it still needs a card, and refuses other types."""
    from repro_torch.launch import trace

    with pytest.raises(RuntimeError, match="CUDA"):
        trace.main(["--dtype", "float32"])
    with pytest.raises(SystemExit):
        trace.main(["--dtype", "float16"])


@pytest.mark.parametrize("symbol", [
    # the mma route, as the profiler names it
    "void (anonymous namespace)::flash_fwd_mma_kernel<float, 64>((anonymous namespace)::Params)",
    "_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_a939580c20flash_fwd_mma_kernelI13__nv_"
    "bfloat16Li112EEEvNS_6ParamsE",
    # the wgmma route: its tensor-map arguments must not make it a matmul
    "void (anonymous namespace)::flash_fwd_wgmma_kernel<64>(CUtensorMap_st, CUtensorMap_st, "
    "CUtensorMap_st, __nv_bfloat16*, int, int, int, int, int, long long, long long, "
    "long long, int, int, float, float)",
    "_ZN57_GLOBAL__N__a6294427_24_flash_attention_wgmma_cu_22dcb6b322flash_fwd_wgmma_kernel"
    "ILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiiixxxiiff",
    # a CUTLASS-named symbol that carries the kernel as a template argument
    "void cutlass::device_kernel<flash_fwd_wgmma_kernel<64> >(cutlass::Params)",
    # the wide route (head_dim above 256)
    "void (anonymous namespace)::flash_fwd_wide_kernel<float>((anonymous namespace)::Params)",
])
def test_trace_kind_of_flash_routes(symbol):
    from repro_torch.launch import trace

    assert trace.kind_of(symbol) == "flash_attention"


@pytest.mark.parametrize("symbol", [
    # each pass of the SSD scan, as the profiler names it
    "void (anonymous namespace)::ssd_chunk_state_kernel<64, 128>((anonymous namespace)::Params, "
    "int)",
    "(anonymous namespace)::ssd_state_pass_kernel(float*, float const*, float*, int, int)",
    "void (anonymous namespace)::ssd_chunk_out_kernel<64, 128>((anonymous namespace)::Params, "
    "int)",
    # mangled, and the smaller instantiations
    "_ZN12_GLOBAL__N_122ssd_chunk_state_kernelILi16ELi8EEEvNS_6ParamsEi",
    "void (anonymous namespace)::ssd_chunk_out_kernel<32, 16>((anonymous namespace)::Params, int)",
])
def test_trace_kind_of_ssd_passes(symbol):
    from repro_torch.launch import trace

    assert trace.kind_of(symbol) == "ssd_scan"
