"""Rules the port keeps: it imports nothing of jax or of the JAX package,
runs on the card unless asked for the CPU, and has no fallback when the
card's pieces (CUDA, nvcc) are missing."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.examples import quickstart, serve_batch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
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
            "ssd_scan.py", "mamba2_370m.py", "zamba2_7b.py", "chatglm3_6b.py",
            "internlm2_20b.py", "h2o_danube_3_4b.py"} <= names
    rel = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES[:-1]}
    assert {f"core/{m}.py" for m in COPIED["core"]} <= rel
    assert {f"topology/{m}.py" for m in COPIED["topology"]} <= rel
    assert {"core/__init__.py", "topology/__init__.py", "comms/__init__.py",
            "comms/executor.py", "comms/primitives.py", "comms/selftest.py"} <= rel
    assert {"launch/sharding.py", "launch/mesh.py", "launch/train_lm.py", "optim/adamw.py",
            "data/pipeline.py", "kernels/flash_attention.py", "launch/dryrun.py",
            "launch/op_cost.py"} <= rel
    assert {"checkpoint/__init__.py", "checkpoint/checkpointer.py", "runtime/__init__.py",
            "runtime/fault_tolerance.py"} <= rel
    assert {f"runtime/{m}.py" for m in COPIED["runtime"]} <= rel
    assert {"models/moe.py", "comms/compression.py", "configs/granite_moe_1b_a400m.py",
            "configs/granite_moe_3b_a800m.py"} <= rel
    assert {"examples/__init__.py", "examples/quickstart.py", "examples/synthesize_pod.py",
            "examples/serve_batch.py"} <= rel
    # every CUDA source is built, the SSD backward's among them
    csrc = {p.stem for p in (ROOT / "src/repro_torch/kernels/csrc").glob("*.cu")}
    assert set(build.SOURCES) == csrc and "ssd_scan_bwd" in csrc


# the planner modules the port copies from the reference, by package
COPIED = {
    "topology": ("topology", "generators"),
    "core": ("errors", "conditions", "request", "algorithm", "ten", "pathfinding",
             "registry", "serialize", "translate", "traffic", "hierarchy", "engine",
             "planservice", "synthesizer", "simulator", "baselines", "repair"),
    "runtime": ("fault_tolerance",),
}
FIX_BEGIN, FIX_END = "# >>> copy fix: ", "# <<< copy fix"
# the marked fixes of the copy: module -> its fixes in file order, each (its
# marker, the first and last reference lines it replaces, how many they are,
# lines the fix must hold)
FIXES = {
    "core/registry.py": [(
        "# >>> copy fix: _store_disk race",
        'tmp = f"{path}.tmp.{os.getpid()}"',
        "self.stats.bytes_stored += os.path.getsize(path)", 12,
        ("os.path.getsize(tmp)", "threading.get_ident()"))],
    # hierarchy: a local phase whose degraded sub-fabric no longer connects
    # its endpoints raises HierarchyError (the engine then goes flat), not a
    # bare AssertionError out of path finding (check_repair_seed(60973))
    "core/hierarchy.py": [(
        "# >>> copy fix: a local phase its sub-fabric cannot connect",
        "pre = None", "pre = None", 1,
        ("sub.hop_matrix()", "raise HierarchyError(", "pre = None"))],
    # finite switch buffers over a chunk's whole stay: the TEN's arrival
    # floors and stay queries, the searches re-timed by them, the preloaded
    # phases' residencies, and plans that still overfill made flat or in waves
    "core/ten.py": [
        ("# >>> copy fix: arrival floors for a chunk's whole stay",
         "# per-switch committed chunk-residency intervals",
         "self._residency: dict[int, list[tuple[float, float]]] = defaultdict(list)", 2,
         ("self._floors: dict[int, float] = {}",)),
        ("# >>> copy fix: a chunk's whole stay in a limited switch buffer",
         "def next_drop_after(self, switch: int, t: float) -> float:",
         "self._residency[switch].append((start, max(end, start)))", 11,
         ("def stay_clash(", "def next_room(", "def switch_stays(", "def commit_stays(",
          "floor = self._floors.get(switch)")),
    ],
    "core/pathfinding.py": [
        ("# >>> copy fix: imports of the two fixes below", "import heapq", "import heapq", 1,
         ("import functools", "import threading")),
        ("# >>> copy fix: a chunk's whole stay in a limited switch buffer",
         "return PathResult(transfers, arrivals, reached)",
         "return PathResult(transfers, arrivals, reached)", 1,
         ("def _first_clash(", "def _whole_stays(", "t = ten.next_room(v, t)",
          "floors.clear()")),
        # two threads searching one topology each get their own scratch
        ("# >>> copy fix: path-finding scratch per thread",
         "def _scratch_for(topo) -> _Scratch:", "return sc", 5,
         ("threading.get_ident()", '"_bfs_scratch"')),
        ("# >>> copy fix: whole stays in the event search",
         "def _bfs_int_switched(", ") -> PathResult:", 3,
         ("@_whole_stays", "def _bfs_int_switched(")),
        ("# >>> copy fix: whole stays in the level search",
         "def bfs_int_ref(", ") -> PathResult:", 3,
         ("@_whole_stays", "def bfs_int_ref(")),
        ("# >>> copy fix: whole stays in the heterogeneous search",
         "def bfs_cont(", "def bfs_cont(", 1,
         ("@_whole_stays", "def bfs_cont(")),
    ],
    "core/engine.py": [
        ("# >>> copy fix: plans that overfill a switch buffer across phases",
         "return CollectiveAlgorithm(forward_topo, list(reduce_conds), rev,",
         "name=name or alg.name, phase_spans=spans)", 2,
         ("def _overfills(", "TEN.switch_stays(", "if occ > limit:")),
        ("# >>> copy fix: the switch residencies of preloaded phases",
         "if preload is not None:", "ten.commit(t.link, t.start, t.end)", 7,
         ("ten.commit_stays(preload.columns)",)),
        ("# >>> copy fix: a hierarchical plan that overfills a switch",
         "return self._hier_impl(kind, g, req)", "return self._hier_impl(kind, g, req)", 1,
         ("not _overfills(alg)", 'req.hierarchy == "always"')),
        ("# >>> copy fix: flat reductions in waves where a switch buffer overfills",
         "def _flat_impl(self, kind, g, req: CollectiveRequest):",
         "def _flat_impl(self, kind, g, req: CollectiveRequest):", 1,
         ("def _in_waves(", "def _flat_plan(", "_overfills(alg)")),
    ],
}


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
    its marked fixes, if it has any: the copy cannot drift silently. Each
    fix is cut out of the copy, and the reference lines it replaces out of
    the reference, in file order."""
    port = _normalised((ROOT / "src" / "repro_torch" / rel).read_text())
    ref = (ROOT / "src" / "repro" / rel).read_text().splitlines()
    for marker, first, last, n_replaced, must_hold in FIXES.get(rel, []):
        port, fix = _cut(port, marker, FIX_END)
        ref, replaced = _cut(ref, first, last)
        assert len(replaced) == n_replaced, marker
        for text in must_hold:
            assert any(text in line for line in fix), (marker, text)
    assert not any(FIX_BEGIN in line for line in port), "a marked fix not listed in FIXES"
    assert port == ref


def test_core_exports_the_references_names():
    """``repro_torch.core`` exports every name of ``repro.core``, in the same
    ``__all__``, and nothing there raises as unported."""
    import repro.core as rcore

    import repro_torch.core as pcore
    from repro_torch.core.repair import PlanRepairer
    from repro_torch.topology import ring

    assert pcore.__all__ == rcore.__all__
    for name in rcore.__all__:
        assert getattr(pcore, name).__name__ == getattr(rcore, name).__name__
    assert not hasattr(pcore, "_NOT_YET_PORTED")
    assert isinstance(pcore.PlanService().repairer(ring(4)), PlanRepairer)


def test_sharding_planner_copy_does_not_drift():
    """``MeshCollectivePlanner`` in the port's ``launch/sharding.py`` is the
    reference's class, its section rule and title included, to the end of
    the reference's module, but for its import lines."""
    port = _normalised((ROOT / "src/repro_torch/launch/sharding.py").read_text())
    ref = (ROOT / "src/repro/launch/sharding.py").read_text().splitlines()
    start = ref.index("class MeshCollectivePlanner:") - 4
    assert ref[start].startswith("# ----")
    i = port.index(ref[start + 1]) - 1
    assert port[i:] == ref[start:]
    assert not any("jax" in line for line in port[:i] if line.lstrip().startswith(
        ("import", "from")))


def test_pad_heads_copy_does_not_drift():
    """``pad_heads`` in the port's ``launch/sharding.py`` is the reference's
    function (its lines 30-39) line for line."""
    port = (ROOT / "src/repro_torch/launch/sharding.py").read_text().splitlines()
    ref = (ROOT / "src/repro/launch/sharding.py").read_text().splitlines()
    start = ref.index("def pad_heads(cfg: ModelConfig, tp: int) -> ModelConfig:")
    end = ref.index("    return dataclasses.replace(cfg, num_heads=hp)", start)
    assert end - start == 9
    i = port.index(ref[start])
    assert port[i:i + end - start + 1] == ref[start:end + 1]


@pytest.mark.parametrize("module", ["launch/mesh.py", "launch/sharding.py"])
def test_mesh_and_sharding_import_no_jax(module):
    """The mesh helpers and ``ShardingPolicy`` import no jax; the
    reference's modules do, directly or through ``repro.jaxcompat``."""
    names = set(_imports(ROOT / "src/repro_torch" / module))
    assert not {n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert {"jax", "repro.jaxcompat"} & set(_imports(ROOT / "src/repro" / module))


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
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_batch.main(["--arch", arch, "--prompt-len", "4", "--new-tokens", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.main(["--arch", arch, "--reduced", "--steps", "1"])
        assert serve_batch.main(["--arch", arch, "--batch", "1", "--prompt-len", "4",
                                 "--new-tokens", "1", "--device", "cpu"]) == 0
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            quickstart.main(device)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-370m", "chatglm3-6b",
                                  "internlm2-20b", "h2o-danube-3-4b", "zamba2-7b",
                                  "granite-moe-1b-a400m", "granite-moe-3b-a800m",
                                  "whisper-medium", "llava-next-34b"])
def test_serve_runs_on_cpu_when_asked(capsys, arch):
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert f"serving {arch}" in out
    assert "prefill: 2x8 tokens" in out and "decode: 3 steps x 2 seqs" in out


def test_registry_holds_every_reference_arch():
    from repro.configs import REGISTRY as REFERENCE

    assert sorted(REGISTRY) == sorted(REFERENCE) and len(REGISTRY) == 10
    for arch in REGISTRY:
        assert get_config(arch).family == REFERENCE[arch].family
    assert get_config("whisper-medium").family == "encdec"
    assert get_config("llava-next-34b").family == "vlm"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


def test_lm_takes_all_six_families():
    from repro_torch.models.transformer import FAMILIES

    assert FAMILIES == ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
    assert {get_config(arch).family for arch in REGISTRY} == set(FAMILIES)
    for arch in REGISTRY:
        assert LM(get_config(arch).reduced(), device="cpu").cfg.family in FAMILIES
    with pytest.raises(ValueError, match="unknown family"):
        LM(get_config("llama3.2-1b").reduced(family="rnn"), device="cpu")


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


@pytest.mark.parametrize("names, leading, trailing", [
    (["pad", "k", "k", "pad"], True, True),
    (["pad", "pad", "k", "pad", "pad"], True, True),
    (["k", "k", "pad"], False, True),  # the leading spin kernels lost
    (["pad", "k", "k"], True, False),  # the trailing ones lost
    (["pad", "pad"], False, False),  # every kernel of the call lost
    ([], False, False),
])
def test_traced_keeps_a_session_only_with_spin_kernels_around_its_kernels(
        names, leading, trailing):
    """``trace.traced`` takes a profiler session as whole only where a spin
    kernel precedes and follows the call's kernels in the card's order, and
    says which end it lost."""
    from repro_torch.launch import trace

    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [(spin if n == "pad" else "void add_kernel(float*)", 10 * i)
              for i, n in enumerate(names)]
    want = {"leading": leading, "trailing": trailing}
    assert trace._ends(events) == want
    assert trace._ends(events[::-1]) == want  # the profiler's order is not the card's


@pytest.mark.parametrize("held, kept, want", [
    ((0, 0), (True, True), (0, 0)),
    ((3, 2), (True, True), (2, 1)),  # a whole session narrows both margins
    ((0, 0), (False, True), (1, 0)),
    ((2, 5), (True, False), (1, 6)),
    ((7, 7), (False, False), (7, 7)),  # the widest margin stays the widest
])
def test_traced_widens_the_margin_of_the_end_it_lost(held, kept, want):
    from repro_torch.launch import trace

    ends = ("leading", "trailing")
    assert trace._step(dict(zip(ends, held)), dict(zip(ends, kept))) == dict(zip(ends, want))
    assert len(trace.MARGINS_S) == 8


def _fake_sessions(monkeypatch, trace, sessions):
    """``trace.traced`` on the CPU: each profiler session returns the next
    list of kernel names ("pad" a spin kernel); records each session's
    margins."""
    import contextlib
    from types import SimpleNamespace

    import torch

    monkeypatch.setattr(trace, "_held", {"leading": 0, "trailing": 0})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    margins = []
    monkeypatch.setattr(trace, "_pads", lambda device, margin, leading: margins.append(
        ("leading" if leading else "trailing", margin)))
    script = iter(sessions)

    @contextlib.contextmanager
    def profile(activities):
        cuda = torch.autograd.DeviceType.CUDA
        names = ["at::cuda::spin_kernel(long)" if n == "pad" else "void add_kernel(float*)"
                 for n in next(script)]
        events = [SimpleNamespace(name=n, device_type=cuda,
                                  time_range=SimpleNamespace(start=10 * i, end=10 * i + 5))
                  for i, n in enumerate(names)]
        # the raw records, listed in another order than the card's
        raw = [SimpleNamespace(name=lambda n=n: n, start_ns=lambda i=i: 10_000 * i,
                               device_type=lambda: cuda)
               for i, n in reversed(list(enumerate(names)))]
        kineto = SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: raw))
        yield SimpleNamespace(events=lambda: events, profiler=kineto)

    monkeypatch.setattr(trace, "profile", profile)
    return margins


def test_traced_runs_a_session_again_until_it_keeps_both_ends(monkeypatch):
    from repro_torch.launch import trace

    margins = _fake_sessions(monkeypatch, trace, [
        ["k", "k", "pad"],  # the leading spin kernels lost
        ["pad", "k", "k"],  # the trailing ones lost
        ["pad", "k", "k", "k", "pad"],
    ])
    calls = []
    r = trace.traced(lambda: calls.append(1), "cpu")
    assert r["sessions"] == 3 and len(calls) == 3
    assert r["launches"] == 3 and r["busy_us"] == 15  # spin kernels left out
    assert margins == [("leading", 0.05), ("trailing", 0.05), ("leading", 0.1),
                       ("trailing", 0.05), ("leading", 0.05), ("trailing", 0.1)]
    assert trace._held == {"leading": 0, "trailing": 0}


def test_traced_raises_after_its_sessions(monkeypatch):
    from repro_torch.launch import trace

    margins = _fake_sessions(monkeypatch, trace, [["k", "pad"]] * trace.SESSIONS)
    with pytest.raises(RuntimeError, match="each of 12 sessions"):
        trace.traced(lambda: None, "cpu")
    leading = [m for end, m in margins if end == "leading"]
    assert leading == [0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2, 6.4, 6.4, 6.4, 6.4, 6.4]


def test_profile_probe_needs_cuda(no_cuda):
    from repro_torch.launch import profile_probe

    with pytest.raises((RuntimeError, AssertionError)):
        profile_probe.main(["--seconds", "0"])


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


@pytest.mark.parametrize("symbol", [
    # each pass of the flash backward, as the profiler names it
    "void (anonymous namespace)::flash_bwd_lse_kernel<__nv_bfloat16, 64>((anonymous namespace)"
    "::Params)",
    "void (anonymous namespace)::flash_bwd_dkdv_kernel<float, 128>((anonymous namespace)::Params)",
    "_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_ae30f0d019flash_bwd_dq_kernelI13__nv_"
    "bfloat16Li128EEEvNS_6ParamsE",
])
def test_trace_kind_of_flash_backward_passes(symbol):
    from repro_torch.launch import trace

    assert trace.kind_of(symbol) == "flash_attention_bwd"


@pytest.mark.parametrize("symbol", [
    # each pass of the SSD backward, as the profiler names it
    "void (anonymous namespace)::ssd_bwd_scores_kernel<128>((anonymous namespace)::Params)",
    "void (anonymous namespace)::ssd_bwd_rev_kernel<64, 128>((anonymous namespace)::Params)",
    "(anonymous namespace)::ssd_bwd_carry_kernel(float*, float const*, int, int)",
    "void (anonymous namespace)::ssd_bwd_chunk_kernel<64, 64>((anonymous namespace)::Params)",
    "(anonymous namespace)::ssd_bwd_sum_kernel(float const*, float const*, float*, float*, int, "
    "long long, long long)",
    "(anonymous namespace)::ssd_bwd_dA_kernel(float const*, float*, int, int)",
    "void (anonymous namespace)::ssd_bwd_inter_kernel<64, 128>((anonymous namespace)::Params)",
    "void (anonymous namespace)::ssd_bwd_dbc_kernel<64, 64>((anonymous namespace)::Params, int)",
    # mangled
    "_ZN12_GLOBAL__N_120ssd_bwd_chunk_kernelILi16ELi8EEEvNS_6ParamsE",
    "_ZN12_GLOBAL__N_121ssd_bwd_chunk_kernelILi64EEEvNS_6ParamsEi",
])
def test_trace_kind_of_ssd_backward_passes(symbol):
    from repro_torch.launch import trace

    assert trace.kind_of(symbol) == "ssd_scan_bwd"


@pytest.mark.parametrize("name", ["ssd_scan_bwd", "flash_attention_bwd"])
def test_backward_dispatch_raises_off_cpu_and_cuda(name):
    """A tensor on neither the CPU nor the card goes to no backward: the
    dispatch raises, it does not fall back."""
    from repro_torch.kernels import ops

    if name == "ssd_scan_bwd":
        B, S, H, P, N = 1, 8, 2, 4, 3
        args = [torch.zeros(s, device="meta") for s in
                ((B, S, H, P), (B, S, H), (H,), (B, S, N), (B, S, N), (B, S, H, P))]
    else:
        args = [torch.zeros((1, 8, 2, 4), device="meta")] * 5
    with pytest.raises(ValueError, match=f"no {name} for device meta"):
        getattr(ops, name)(*args)
