"""Per-device cost of one call, counted op by op as it runs: the counterpart
of ``repro/launch/hlo_cost.py``.

The reference derives FLOPs, bytes and collective bytes from the compiled,
SPMD-partitioned HLO of a program. The port is not compiled, so there is no
HLO and no HLO parser here: ``analyze(fn, *args)`` runs ``fn`` under a
``TorchDispatchMode`` that sees every aten op, every operator of the port's
kernels (``torch.ops.repro_torch``) and every collective, once each, as it
runs. Under ``FakeTensorMode`` nothing is computed and nothing is
allocated, so a production cell on a fake process group of 256 or 512
ranks costs a few seconds of host time (``launch/dryrun.py``).

The counting rules, after the reference's (hlo_cost.py:8-16):

  products      -> their FLOP formula (``torch.utils.flop_counter``: mm,
                   bmm, addmm, baddbmm, convolution, the SDPA ops, and the
                   four kernel operators through ``kernels/ops``)
  transcendental elementwise (exp, log, tanh, rsqrt, sqrt, pow, sigmoid,
                   sin, cos, expm1)
                -> one FLOP and one transcendental an output element
  composite ops (softmax, log-softmax, silu, softplus and their backwards)
                -> the elementwise ops that XLA would expand them into
  other elementwise ops
                -> one FLOP an output element
  views, copies, casts, creation, index ops, comparisons, selects and
  reductions (the reference's ``_ZERO_COST_OPS``)
                -> nothing
  collectives   -> result bytes tallied by kind (every ``_c10d_functional``
                   op, its autograd variants and the in-place ``c10d`` ops)

``bytes`` is the operand plus result bytes of each op that does work: in
eager mode each such op is its own kernel, so this is the same HBM-traffic
proxy that the reference takes a fusion. Collectives, waits and free ops
add no bytes.

Per device: an op on DTensors is not counted at its global shapes. The
mode returns ``NotImplemented`` for it, so DTensor runs it, and the ops
that DTensor then issues on each rank's local tensors (the local product,
the redistribution's collectives) come back to the mode and are counted
at their local shapes. A counter that sits above DTensor (as
``FlopCounterMode`` does) counts global work.

DTensor's sharding propagation is not counted: to read an op's output
shape it makes tensors of the op's global shapes (on the meta device, or
fake ones under the fake mode) and runs the op on them. The mode marks the
tensors that a factory makes while ``_sharding_prop.py`` is on the stack,
and every op on such tensors or on meta tensors, and leaves them out.

The mode also follows the storages that the ops create, and records the
peak of those alive at once (``peak_bytes``): what a step allocates above
its arguments, outputs included. Scratch that a kernel wrapper allocates
inside its operator is not seen.
"""

from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0  # HBM traffic proxy: operand + result bytes an op that works
    transcendentals: float = 0.0
    collective_bytes: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)
    flops_by_op: dict = field(default_factory=dict)  # aten / kernel op name -> FLOPs
    peak_bytes: int = 0  # most bytes alive at once of storages made during the call

    def add(self, other: "Cost", factor: float = 1.0):
        self.flops += other.flops * factor
        self.bytes += other.bytes * factor
        self.transcendentals += other.transcendentals * factor
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = self.collective_bytes.get(k, 0) + v * factor
        for k, v in other.collective_counts.items():
            self.collective_counts[k] = (
                self.collective_counts.get(k, 0) + v * factor)
        for k, v in other.flops_by_op.items():
            self.flops_by_op[k] = self.flops_by_op.get(k, 0) + v * factor

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


# collective op name (any of the collective namespaces) -> kind
_COLLECTIVES = {
    **dict.fromkeys(("all_gather_into_tensor", "all_gather_into_tensor_out",
                     "all_gather_into_tensor_coalesced", "allgather_",
                     "_allgather_base_", "allgather_coalesced_",
                     "allgather_into_tensor_coalesced_"), "all-gather"),
    **dict.fromkeys(("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced",
                     "reduce_scatter_", "_reduce_scatter_base_",
                     "reduce_scatter_tensor_coalesced_"), "reduce-scatter"),
    **dict.fromkeys(("all_reduce", "all_reduce_", "all_reduce_coalesced",
                     "all_reduce_coalesced_", "allreduce_", "allreduce_coalesced_"),
                    "all-reduce"),
    **dict.fromkeys(("all_to_all_single", "alltoall_", "alltoall_base_",
                     "shard_dim_alltoall"), "all-to-all"),
    **dict.fromkeys(("send", "recv_", "recv_any_source_"), "collective-permute"),
    **dict.fromkeys(("broadcast", "broadcast_"), "broadcast"),
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
                          "_dtensor")
_FREE_COLLECTIVE_OPS = {"wait_tensor", "barrier", "monitored_barrier", "_wrap_tensor_autograd"}

_ELEMENTWISE_TRANS = {"exp", "exp_", "exp2", "log", "log_", "log1p", "log2", "tanh",
                      "tanh_", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "pow", "pow_",
                      "sigmoid", "sigmoid_", "sin", "cos", "expm1"}
# composite op -> (FLOPs, transcendentals) an output element, as XLA expands it
_COMPOSITE = {
    "_softmax": (3, 1),  # x - max, exp, / sum (the reductions are free)
    "_log_softmax": (3, 1),  # x - max, exp, - log sum
    "_softmax_backward_data": (3, 0),  # g y, - sum, * y
    "_log_softmax_backward_data": (3, 1),  # exp y, * sum, g -
    "silu": (2, 1),  # sigmoid, *
    "silu_": (2, 1),
    "silu_backward": (4, 1),  # sigmoid, 1 - s, x (1 - s) + 1, * s g
    "softplus": (2, 2),  # exp, log1p (the threshold is a select)
    "softplus_backward": (3, 1),  # exp, / (1 + e), * g
    "sigmoid_backward": (3, 0),
    "tanh_backward": (3, 0),
}
_ZERO_COST_OPS = {
    # views and layout
    "view", "_unsafe_view", "reshape", "_reshape_alias", "permute", "transpose", "t",
    "expand", "squeeze", "unsqueeze", "slice", "select", "as_strided", "alias", "detach",
    "split", "split_with_sizes", "unbind", "chunk", "narrow", "unflatten", "flatten",
    "diagonal", "view_as_real", "view_as_complex", "lift_fresh", "lift_fresh_copy",
    "unfold", "movedim", "squeeze_", "unsqueeze_", "transpose_", "t_",
    # copies and casts
    "clone", "copy_", "_to_copy", "to", "contiguous", "_copy_from",
    "_copy_from_and_resize", "copy", "_has_compatible_shallow_copy_type",
    # creation (broadcast constants, iota, rng)
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros", "new_ones",
    "new_full", "scalar_tensor", "arange", "fill", "fill_", "zero_", "randn", "rand",
    "randint", "randn_like", "rand_like", "normal_", "uniform_", "bernoulli_", "tril",
    "triu", "eye", "linspace",
    # index ops, concatenation, padding
    "index", "index_select", "gather", "scatter", "scatter_", "scatter_add",
    "scatter_add_", "index_put", "index_put_", "index_add", "index_add_", "embedding",
    "embedding_dense_backward", "slice_backward", "select_backward", "cat", "stack",
    "constant_pad_nd", "pad", "flip", "roll", "repeat", "repeat_interleave",
    "slice_scatter", "select_scatter", "index_copy", "masked_select", "nonzero",
    "nll_loss_backward", "nll_loss2d_backward", "expand_copy", "_unsafe_index",
    # selects and comparisons
    "where", "masked_fill", "masked_fill_", "nan_to_num", "clamp", "clamp_",
    "clamp_min", "clamp_max", "eq", "ne", "lt", "le", "gt", "ge", "isinf", "isnan",
    "isfinite", "logical_not", "bitwise_not", "sign",
    # reductions and sorts
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod", "any",
    "all", "sort", "topk", "std", "var",
    # scalars and metadata
    "_local_scalar_dense", "item", "device", "sym_size", "sym_stride", "sym_numel",
    "is_same_size", "promote_types", "resize_", "set_", "record_stream",
}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _elems(ts) -> int:
    return sum(t.numel() for t in ts)


def op_name(func) -> str:
    """'aten.mm', 'repro_torch.flash_attention', '_c10d_functional.all_reduce'."""
    return f"{func.namespace}.{func._overloadpacket.__name__}"


class _Live:
    """Bytes alive of the storages created since the start, and their peak."""

    def __init__(self):
        self.now = 0
        self.peak = 0
        self._seen = weakref.WeakSet()

    def _free(self, nbytes: int) -> None:
        self.now -= nbytes

    def existing(self, ts) -> None:
        """Storages of ``ts`` that exist already: never counted."""
        for t in ts:
            self._seen.add(t.untyped_storage())

    def created(self, ts) -> None:
        for t in ts:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            nbytes = st.nbytes()
            self._seen.add(st)
            weakref.finalize(st, self._free, nbytes)
            self.now += nbytes
            self.peak = max(self.peak, self.now)


class CostMode(TorchDispatchMode):
    """Tallies each op that runs under it into ``cost`` (the rules in the
    module docstring), at local shapes under DTensor. The storages of the
    ``existing`` tensors (the arguments) are not counted as created."""

    def __init__(self, existing=()):
        super().__init__()
        self.cost = Cost()
        self._live = _Live()
        self._live.existing(existing)
        self._shadow = weakref.WeakSet()  # storages of DTensor's sharding propagation

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it; its local ops come back here
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        shadow = (any(t.untyped_storage() in self._shadow for t in ins) if ins
                  else _in_sharding_propagation())
        out = func(*args, **kwargs)
        if shadow or any(t.device.type == "meta" for t in ins):
            for t in _tensors(out):
                self._shadow.add(t.untyped_storage())
            return out  # DTensor reading an output's shape, not a rank's work
        self._count(func, args, kwargs, out)
        self._live.created(_tensors(out))
        self.cost.peak_bytes = self._live.peak
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        name = func._overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVES.get(name)
            if kind is None:
                if name not in _FREE_COLLECTIVE_OPS:
                    raise NotImplementedError(f"op_cost: collective {op_name(func)} has no "
                                              f"kind")
                return
            nbytes = _nbytes(_tensors(out)) or _nbytes(_tensors(args))
            c.collective_bytes[kind] = c.collective_bytes.get(kind, 0) + nbytes
            c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
            return
        packet = func._overloadpacket
        outs = _tensors(out)
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            trans = _kernel_transcendentals(name, args) if func.namespace == "repro_torch" \
                else 0
        elif name in _ZERO_COST_OPS or func.namespace == "prim":
            return
        elif name in ("pow", "pow_") and isinstance(args[1], (int, float)) and args[1] == 2:
            flops, trans = _elems(outs), 0  # a square is a multiply
        elif name in _ELEMENTWISE_TRANS:
            flops = trans = _elems(outs)
        elif name in _COMPOSITE:
            f, tr = _COMPOSITE[name]
            flops, trans = f * _elems(outs), tr * _elems(outs)
        else:
            flops, trans = _elems(outs), 0  # generic elementwise
        c.flops += flops
        c.transcendentals += trans
        key = op_name(func)
        c.flops_by_op[key] = c.flops_by_op.get(key, 0) + flops
        c.bytes += _nbytes(_tensors((args, kwargs))) + _nbytes(outs)


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the stack: it makes
    tensors of an op's global shapes and runs the op on them (under the
    fake mode of a fake trace) to read the output's shape."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        frame = frame.f_back
    return False


def _kernel_transcendentals(name: str, args) -> int:
    """The exponentials of a kernel operator: one a visible (query, key)
    pair and head for the flash forward, again in the backward's recompute;
    one a causal pair and head (the decay L) and two a position and head
    for the SSD scan, forward and backward."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    if name.startswith("flash_attention"):
        q, k = args[0], args[1]
        causal, window = args[5:7] if name == "flash_attention_bwd" else args[3:5]
        B, S, H, _ = q.shape
        return B * H * fa.visible_pairs(S, k.shape[1], causal, window)
    B, S, H, _ = args[0].shape
    chunk = args[5] if name == "ssd_scan" else args[6]
    Q = max(1, min(chunk, ssd.MAX_CHUNK))
    total = 0
    for start in range(0, S, Q):
        q = min(Q, S - start)
        total += q * (q + 1) // 2 + 2 * q
    return B * H * total


def analyze(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its per-device ``Cost``). Every op of the call
    is counted once; the storages of the arguments' tensors (plain or the
    local tensors of DTensors) are not counted as created."""
    mode = CostMode(existing=local_tensors((args, kwargs)))
    with mode:
        result = fn(*args, **kwargs)
    return result, mode.cost


def local_tensors(tree) -> list:
    """The tensors of ``tree``: each DTensor's local tensor, each plain
    tensor as it is (dicts, lists, tuples and dataclasses walked)."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    out = []
    if isinstance(tree, dict):
        for v in tree.values():
            out += local_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out += local_tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            out += local_tensors(getattr(tree, f.name))
    elif isinstance(tree, DTensor):
        out.append(tree.to_local())
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out
