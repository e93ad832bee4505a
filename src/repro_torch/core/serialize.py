"""Columnar plan persistence: uncompressed ``.npz`` entries, mmap-loadable.

The registry's on-disk format is one ``.npz`` per canonical algorithm: the
seven transfer columns verbatim, the conditions flattened into parallel
arrays (ragged ``dests``/``srcs`` sets in CSR ``flat + indptr`` form), and
the phase-span provenance. Entries are written uncompressed, so a load can
``mmap`` the file and hand the kernel-backed pages straight to numpy — no
parse, no per-row objects, and nothing is faulted in until a consumer
actually touches a column. A 4 M-transfer plan "loads" in the time it takes
to read the zip directory.

``np.load(mmap_mode=...)`` silently ignores mmap for ``.npz`` archives, so
the loader walks the zip members itself: for each ZIP_STORED entry it reads
the local file header to find the data offset, parses the ``.npy`` header,
and builds the array with ``np.frombuffer`` over one shared ``mmap``. The
resulting arrays are read-only — which is exactly the columnar contract
(:class:`~repro.core.algorithm.TransferColumns` never mutates in place).

Malformed files of any kind — truncated zip, wrong dtype, mismatched column
lengths, foreign topology fingerprint — raise ``ValueError`` so the registry
can drop the entry and resynthesize.
"""

from __future__ import annotations

import io
import mmap
import os
import zipfile

import numpy as np

from repro_torch.core.algorithm import CollectiveAlgorithm, TransferColumns
from repro_torch.core.conditions import Condition, ReduceCondition
from repro_torch.topology.topology import Topology

# On-disk plan schema. v1: transfer columns + CSR conditions + phase spans.
PLAN_NPZ_VERSION = 1

# column name -> required on-disk dtype; anything else is a corrupt entry
_TRANSFER_FIELDS = {
    "t_chunk": np.dtype(np.int64),
    "t_link": np.dtype(np.int32),
    "t_src": np.dtype(np.int32),
    "t_dst": np.dtype(np.int32),
    "t_start": np.dtype(np.float64),
    "t_end": np.dtype(np.float64),
    "t_reduce": np.dtype(np.bool_),
}
_COND_FIELDS = {
    "c_chunk": np.dtype(np.int64),
    "c_bytes": np.dtype(np.float64),
    "c_release": np.dtype(np.float64),
    "c_is_reduce": np.dtype(np.bool_),
    "c_origin": np.dtype(np.int64),
    "c_dests_flat": np.dtype(np.int64),
    "c_dests_indptr": np.dtype(np.int64),
    "c_srcs_flat": np.dtype(np.int64),
    "c_srcs_indptr": np.dtype(np.int64),
}


def _csr(sets: list) -> tuple[np.ndarray, np.ndarray]:
    indptr = np.zeros(len(sets) + 1, np.int64)
    for i, s in enumerate(sets):
        indptr[i + 1] = indptr[i] + len(s)
    flat = np.fromiter((x for s in sets for x in s), np.int64,
                       int(indptr[-1]))
    return flat, indptr


def save_plan_npz(path: str, alg: CollectiveAlgorithm,
                  fingerprint: str) -> None:
    """Write ``alg`` as an uncompressed npz at ``path`` (not atomic — the
    caller owns tmp-file + rename semantics). ``fingerprint`` is the
    topology structure hash the plan belongs to; loads verify it."""
    cols = alg.columns
    conds = alg.conditions
    # sorted(set) keeps the on-disk bytes deterministic; condition order
    # itself is preserved exactly (renumber_chunks allocates ids by it)
    dflat, dptr = _csr([sorted(c.dests) for c in conds])
    sflat, sptr = _csr([sorted(c.srcs) if isinstance(c, ReduceCondition)
                        else () for c in conds])
    nc = len(conds)
    spans = alg.phase_spans
    arrays = {
        "schema": np.array([PLAN_NPZ_VERSION], np.int64),
        "fingerprint": np.array([fingerprint]),
        "name": np.array([alg.name]),
        "t_chunk": cols.chunk, "t_link": cols.link,
        "t_src": cols.src, "t_dst": cols.dst,
        "t_start": cols.start, "t_end": cols.end, "t_reduce": cols.reduce,
        "c_chunk": np.fromiter((c.chunk for c in conds), np.int64, nc),
        "c_bytes": np.fromiter((c.bytes for c in conds), np.float64, nc),
        "c_release": np.fromiter((c.release for c in conds), np.float64, nc),
        "c_is_reduce": np.fromiter(
            (isinstance(c, ReduceCondition) for c in conds), np.bool_, nc),
        "c_origin": np.fromiter(
            (getattr(c, "src", -1) for c in conds), np.int64, nc),
        "c_tag": np.array([c.tag for c in conds]),
        "c_dests_flat": dflat, "c_dests_indptr": dptr,
        "c_srcs_flat": sflat, "c_srcs_indptr": sptr,
        "p_name": np.array([s[0] for s in spans]),
        "p_lo": np.array([float(s[1]) for s in spans], np.float64),
        "p_hi": np.array([float(s[2]) for s in spans], np.float64),
    }
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _mmap_npz(path: str) -> dict[str, np.ndarray]:
    """Zero-copy view of every array in an uncompressed npz: one shared
    read-only mmap, ``np.frombuffer`` per member at its zip data offset.
    The mmap stays alive through the arrays' ``.base`` chain."""
    # one fd for both the zip directory and the data mmap: a concurrent
    # atomic replace of `path` cannot mix old offsets with new bytes, and
    # the mapping stays valid even if the entry is unlinked underneath us
    f = open(path, "rb")
    try:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        with zipfile.ZipFile(f) as zf:
            infos = zf.infolist()
    finally:
        f.close()
    out: dict[str, np.ndarray] = {}
    for info in infos:
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{info.filename}: compressed member in plan npz")
        ho = info.header_offset
        if mm[ho:ho + 4] != b"PK\x03\x04":
            raise ValueError(f"{info.filename}: bad local file header")
        name_len = int.from_bytes(mm[ho + 26:ho + 28], "little")
        extra_len = int.from_bytes(mm[ho + 28:ho + 30], "little")
        data_off = ho + 30 + name_len + extra_len
        hdr = io.BytesIO(mm[data_off:data_off + min(info.file_size, 4096)])
        version = np.lib.format.read_magic(hdr)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(hdr)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(hdr)
        else:
            raise ValueError(f"{info.filename}: npy format {version}")
        if fortran or dtype.hasobject:
            raise ValueError(f"{info.filename}: unsupported npy layout")
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(mm, dtype=dtype, count=count,
                            offset=data_off + hdr.tell())
        name = info.filename
        if name.endswith(".npy"):
            name = name[:-4]
        out[name] = arr.reshape(shape)
    return out


def load_plan_npz(path: str, topology: Topology, *,
                  use_mmap: bool = True) -> CollectiveAlgorithm:
    """Load a plan written by :func:`save_plan_npz` for ``topology``.

    With ``use_mmap`` (the default) the transfer columns are zero-copy
    views over the file — validated by metadata (dtype, shape, length
    consistency) only, so nothing large is faulted in at load time.
    Raises ``ValueError`` for any malformed or foreign entry."""
    try:
        if use_mmap:
            arrays = _mmap_npz(path)
        else:
            with np.load(path, allow_pickle=False) as npz:
                arrays = {k: npz[k] for k in npz.files}
    except OSError:
        raise
    except ValueError:
        raise
    except Exception as exc:  # zipfile/struct errors on garbage bytes
        raise ValueError(f"unreadable plan npz: {exc}") from exc

    def get(key: str, dtype: np.dtype | None = None) -> np.ndarray:
        if key not in arrays:
            raise ValueError(f"plan npz missing array {key!r}")
        arr = arrays[key]
        if arr.ndim != 1:
            raise ValueError(f"{key}: expected 1-d array, got {arr.shape}")
        if dtype is not None and arr.dtype != dtype:
            raise ValueError(f"{key}: dtype {arr.dtype} != {dtype}")
        return arr

    schema = get("schema", np.dtype(np.int64))
    if len(schema) != 1 or int(schema[0]) != PLAN_NPZ_VERSION:
        raise ValueError(f"plan npz schema {schema} != {PLAN_NPZ_VERSION}")
    fp = get("fingerprint")
    from repro_torch.core.registry import topology_fingerprint
    if len(fp) != 1 or str(fp[0]) != topology_fingerprint(topology):
        raise ValueError("plan npz topology fingerprint mismatch")
    name_arr = get("name")
    if len(name_arr) != 1:
        raise ValueError("plan npz malformed name")

    tcols = {k: get(k, dt) for k, dt in _TRANSFER_FIELDS.items()}
    n = len(tcols["t_chunk"])
    if any(len(a) != n for a in tcols.values()):
        raise ValueError("plan npz transfer columns disagree on length")

    ccols = {k: get(k, dt) for k, dt in _COND_FIELDS.items()}
    ctag = get("c_tag")
    nc = len(ccols["c_chunk"])
    if any(len(ccols[k]) != nc for k in
           ("c_bytes", "c_release", "c_is_reduce", "c_origin")) \
            or len(ctag) != nc:
        raise ValueError("plan npz condition columns disagree on length")
    for flat, indptr in (("c_dests_flat", "c_dests_indptr"),
                         ("c_srcs_flat", "c_srcs_indptr")):
        ptr = ccols[indptr]
        if (len(ptr) != nc + 1 or (nc >= 0 and (len(ptr) == 0
                or ptr[0] != 0 or int(ptr[-1]) != len(ccols[flat])
                or (np.diff(ptr) < 0).any()))):
            raise ValueError(f"plan npz {indptr} is not a valid CSR index")

    pname = get("p_name")
    plo = get("p_lo", np.dtype(np.float64))
    phi = get("p_hi", np.dtype(np.float64))
    if len(plo) != len(pname) or len(phi) != len(pname):
        raise ValueError("plan npz phase spans disagree on length")

    conds: list = []
    dptr, dflat = ccols["c_dests_indptr"], ccols["c_dests_flat"]
    sptr, sflat = ccols["c_srcs_indptr"], ccols["c_srcs_flat"]
    for i in range(nc):
        dests = frozenset(dflat[int(dptr[i]):int(dptr[i + 1])].tolist())
        common = dict(chunk=int(ccols["c_chunk"][i]), dests=dests,
                      bytes=float(ccols["c_bytes"][i]),
                      release=float(ccols["c_release"][i]),
                      tag=str(ctag[i]))
        if bool(ccols["c_is_reduce"][i]):
            srcs = frozenset(sflat[int(sptr[i]):int(sptr[i + 1])].tolist())
            conds.append(ReduceCondition(srcs=srcs, **common))
        else:
            conds.append(Condition(src=int(ccols["c_origin"][i]), **common))

    cols = TransferColumns(
        tcols["t_chunk"], tcols["t_link"], tcols["t_src"], tcols["t_dst"],
        tcols["t_start"], tcols["t_end"], tcols["t_reduce"],
        presorted=True)
    spans = [(str(pname[i]), float(plo[i]), float(phi[i]))
             for i in range(len(pname))]
    return CollectiveAlgorithm(topology, conds, cols,
                               name=str(name_arr[0]), phase_spans=spans)


def plan_disk_bytes(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0
