"""Build the port's CUDA kernels from the sources in ``csrc/`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries go to
``build/repro_torch_kernels/`` at the repo root, named by the hash of their
source and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. A failed build raises with nvcc's output; nothing falls
back to another implementation.

``flash_attention_wgmma.cu`` builds TMA tensor maps on the host with
``cuTensorMapEncodeTiled``, a driver function. It takes the function from
the driver that the CUDA runtime has loaded (``cudaGetDriverEntryPoint``), so
no library is linked with ``-lcuda`` and the flags are the same for every
source; ``cuda.h`` is included for the types alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
CUDA_HOMES = ("/usr/local/cuda",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("flash_attention", "flash_attention_wgmma", "flash_attention_wide", "ssd_scan")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    """nvcc from PATH, $CUDA_HOME/bin or the standard toolkit location."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ[v] for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    for home in (*homes, *CUDA_HOMES):
        cand = Path(home) / "bin" / "nvcc"
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
        "port's CUDA kernels cannot be built")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for ``name`` unless its library is built; returns
    (library path, process or None)."""
    src, lib = _target(name)
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return lib, (proc, tmp)


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every named kernel library, one nvcc per source, all started
    together. Returns nvcc's output per source (kept beside the library, so
    a cached build reports the same registers and spills)."""
    nvcc = find_nvcc()
    started = {n: _start(n, nvcc) for n in names}
    logs = {}
    for name, (lib, job) in started.items():
        log = lib.with_suffix(".log")
        if job is not None:
            proc, tmp = job
            out, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise KernelBuildError(f"nvcc failed on {name}.cu "
                                       f"(exit {proc.returncode}):\n{out}")
            log.write_text(out)
            os.replace(tmp, lib)
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        if name not in _loaded:
            build_all([name])
            _loaded[name] = ctypes.CDLL(str(_target(name)[1]))
        return _loaded[name]
