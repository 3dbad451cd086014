"""Per-device cost of one eager step: operations, bytes, collectives, peak.

The port's counterpart of the JAX package's ``repro/launch/hlo_cost.py``,
which re-derives loop-aware costs from a compiled XLA module's HLO text.
Eager PyTorch has no module to parse and no loops to multiply out: every
iteration runs.  So :class:`OpCounter` is a ``TorchDispatchMode`` that
sees each ATen operation as it runs, on real tensors or on meta ones (the
dry run's), and keeps ``hlo_cost``'s conventions:

  * a product is 2·M·N·K (``mm``, ``bmm``, ``addmm``, ``baddbmm``, which
    einsum lowers to, and ``convolution`` and its backward), also kept by
    its operands' dtype (``product_flops_by_dtype``: the roofline rates
    float32 products at the float32 peak);
  * an elementwise operation is 1 a result element; a transcendental one
    1 plus 1 transcendental; a reduction 1 an operand element;
  * bytes are operands plus results of every operation that launches a
    kernel (eager PyTorch's own HBM traffic, nothing fused); views,
    metadata and allocations count 0, a fill or a copy only what it
    writes (and, for a copy, reads);
  * collectives are the ``_c10d_functional`` operations and the ``c10d``
    ones ``torch.distributed`` issues: kind, group size and link
    (``roofline.link_of``), result bytes × ``roofline.wire_factor``; a
    ``wait_tensor`` is part of its collective and counts nothing.

The port's hand-written kernels run outside the dispatcher; each wrapper
tells the counter its operations and bound bytes (``kernels.cost``), on
its launch and on its shape-only branch for fake tensors.

**Per device under DTensor.**  A DTensor operation reaches this mode with
the ``DTensor`` type first; the mode returns ``NotImplemented``, DTensor
unwraps it and runs the local shard's operations (and any redistribution's
collectives), which reach the mode again on plain (or meta) tensors:
those are what one device does.  DTensor's sharding propagation also runs the
operation once more at the *global* shape, on fake tensors, to learn the
output's metadata (``ShardingPropagator._propagate_tensor_meta_non_cached``,
cached per signature, so only on the first call).  That run is no work of
any device, so while the counter is active it wraps that method and
ignores every operation inside it, the fake inputs it allocates too.  It
was chosen over telling the two apart by shape or by tensor type because
a local shard can have the global shape (a replicated tensor) and a
tensor type of its own (a fake one): only the call site says which is
which.

**Speed.**  On meta tensors (the dry run) an operation's output shapes
are memoized by its signature: the second layer of a stack, and every
later chunk of an attention loop, makes its outputs with
``empty_strided`` instead of running the meta kernel again (most meta
kernels are Python decompositions).  Views, aliases and in-place
operations always run.

**Peak bytes.**  Every new storage an operation returns adds its bytes to
the live total, and a weak reference on the storage takes them off when it
is freed; ``peak_bytes`` is the largest total, beyond what was live when
the counter started (the step's arguments).
"""
from __future__ import annotations

import threading
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import cost as kernel_cost
from . import roofline

aten = torch.ops.aten

_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "mv", "dot", "vdot",
             "convolution", "convolution_backward"}
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum",
    "clamp", "clamp_min", "clamp_max", "where", "eq", "ne", "lt", "le", "gt",
    "ge", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor", "relu",
    "threshold_backward", "sign", "floor", "ceil", "round", "trunc",
    "remainder", "fmod", "lerp", "addcmul", "addcdiv", "reciprocal",
    "masked_fill", "square", "hardtanh", "leaky_relu", "tril", "triu",
    "isnan", "isinf", "nan_to_num", "frac"}
_TRANSCENDENTAL = {
    "exp", "exp2", "log", "log2", "log10", "log1p", "expm1", "tanh",
    "sigmoid", "rsqrt", "sqrt", "pow", "sin", "cos", "erf", "erfinv", "silu",
    "gelu", "softplus", "sigmoid_backward", "tanh_backward", "silu_backward",
    "gelu_backward", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "atan2", "logit"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
               "std", "var_mean", "std_mean", "norm", "linalg_vector_norm",
               "argmax", "argmin", "any", "all", "cumsum", "cumprod",
               "logsumexp", "count_nonzero"}
# Allocations and host reads: no kernel, no bytes.
_NO_KERNEL = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "_local_scalar_dense", "lift_fresh",
              "lift_fresh_copy", "detach", "alias", "is_same_size", "sym_size",
              "sym_stride", "sym_numel", "sym_storage_offset", "size", "stride",
              "is_nonzero", "_has_compatible_shallow_copy_type"}
# Writes only: what the result holds.
_FILLS = {"fill", "zero", "zeros", "zeros_like", "ones", "ones_like", "full",
          "full_like", "new_zeros", "new_ones", "new_full", "arange", "eye",
          "scalar_tensor", "randn", "rand", "randint", "normal", "uniform",
          "bernoulli", "randperm"}

_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d", "_c10d_functional_autograd")

# Depth of DTensor's sharding propagation on this process: operations
# inside it are not a device's work.
_prop = threading.local()


def _in_propagation() -> bool:
    return getattr(_prop, "depth", 0) > 0


def _tensors(tree, out=None) -> list:
    # Module-level, not a recursive closure: a closure's reference cycle
    # would hold the tensors it saw until the cyclic collector runs, and
    # keep freed storages live in the count.
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _memo_key(func, args, kwargs, ins):
    """A hashable signature of an operation on meta tensors (each tensor's
    shape, strides, dtype; every other argument's value), or None where a
    tensor is not on the meta device or an argument does not hash."""
    if not ins or any(t.device.type != "meta" or type(t) is not torch.Tensor
                      for t in ins):
        return None

    def sig(x):
        if isinstance(x, torch.Tensor):
            return ("T", tuple(x.shape), x.stride(), x.dtype)
        if isinstance(x, (list, tuple)):
            return tuple(sig(v) for v in x)
        if isinstance(x, dict):
            return tuple(sorted((k, sig(v)) for k, v in x.items()))
        return x
    key = (func, sig(args), sig(kwargs))
    try:
        hash(key)
    except TypeError:
        return None
    return key


def _spec_of(out, in_keys):
    """``out``'s shapes, strides and dtypes where every tensor in it is a
    fresh storage of its own (a view or an alias of an input is not
    memoized), else None."""
    seen = set()

    def spec(x):
        if isinstance(x, torch.Tensor):
            k = _storage_key(x)
            if k is None or k in in_keys or k in seen or x.storage_offset():
                raise LookupError
            seen.add(k)
            return ("T", tuple(x.shape), x.stride(), x.dtype)
        if isinstance(x, (list, tuple)):
            return (type(x), tuple(spec(v) for v in x))
        if x is None or isinstance(x, (int, float, bool)):
            return ("V", x)
        raise LookupError
    try:
        return spec(out)
    except LookupError:
        return None


def _from_spec(spec):
    if spec[0] == "T":
        return torch.empty_strided(spec[1], spec[2], dtype=spec[3], device="meta")
    if spec[0] == "V":
        return spec[1]
    return spec[0](_from_spec(s) for s in spec[1])


def _group_of(args):
    """The process group a collective's arguments name (a funcol group name
    or a ``ProcessGroup``), or None."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, ProcessGroup):
            return a
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a)
            except (RuntimeError, TypeError):     # not a boxed group
                continue
    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a)
            except (ValueError, KeyError, RuntimeError):
                continue
    return None


def _product_flops(name: str, args, out) -> float:
    if name in ("mm", "addmm", "bmm", "baddbmm"):
        a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else args[:2]
        m, k = a.shape[-2], a.shape[-1]
        n = b.shape[-1]
        batch = a.shape[0] if a.dim() == 3 else 1
        return 2.0 * batch * m * k * n
    if name == "mv":
        return 2.0 * args[0].numel()
    if name in ("dot", "vdot"):
        return 2.0 * args[0].numel()
    if name == "convolution":
        x, w = args[0], args[1]
        transposed = bool(args[6])
        if transposed:   # w [Cin, Cout/g, k...]: every input value's taps
            return 2.0 * x.numel() * w.numel() / max(w.shape[0], 1)
        return 2.0 * out.numel() * w.numel() / max(w.shape[0], 1)
    if name == "convolution_backward":
        g, x, w = args[0], args[1], args[2]
        transposed = bool(args[7])
        mask = args[10]
        fwd = (2.0 * x.numel() * w.numel() / max(w.shape[0], 1) if transposed
               else 2.0 * g.numel() * w.numel() / max(w.shape[0], 1))
        return fwd * (int(bool(mask[0])) + int(bool(mask[1])))
    return 0.0


class OpCounter(TorchDispatchMode):
    """Counts what runs under it (``with OpCounter() as c: step()``), per
    device; :meth:`result` gives ``hlo_cost.analyze``'s keys plus
    ``peak_bytes``, ``by_kernel``, ``product_flops`` and
    ``product_flops_by_dtype``."""

    def __init__(self):
        super().__init__()
        # Output shapes of meta operations by signature (see _memo_key).
        self._memo: dict = {}
        self._views: set = set()      # operations seen returning a view
        self.flops = 0.0
        self.product_flops = 0.0
        self.product_flops_by_dtype: dict[str, float] = {}
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.collective_hbm_bytes = 0.0   # of ``bytes``: the collectives'
        self.collectives: list[dict] = []
        self.by_kernel: dict[str, dict] = {}
        self.live = 0
        self.peak = 0
        self._tracked: dict = {}
        self._patched = None

    # ---- sharding propagation is not a device's work --------------------
    def _patch_propagation(self):
        try:
            from torch.distributed.tensor._sharding_prop import ShardingPropagator
        except ImportError:
            return
        name = "_propagate_tensor_meta_non_cached"
        if not hasattr(ShardingPropagator, name):
            name = "_propagate_tensor_meta"
        orig = getattr(ShardingPropagator, name)

        def wrapped(self_, *a, **kw):
            _prop.depth = getattr(_prop, "depth", 0) + 1
            try:
                return orig(self_, *a, **kw)
            finally:
                _prop.depth -= 1
        setattr(ShardingPropagator, name, wrapped)
        self._patched = (ShardingPropagator, name, orig)

    def __enter__(self):
        self._patch_propagation()
        kernel_cost.add_sink(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            kernel_cost.remove_sink(self._kernel)
            if self._patched is not None:
                cls, name, orig = self._patched
                setattr(cls, name, orig)
                self._patched = None

    # ---- the port's kernels ----------------------------------------------
    def _product(self, flops: float, dtype: torch.dtype) -> None:
        self.flops += flops
        self.product_flops += flops
        key = str(dtype).removeprefix("torch.")
        self.product_flops_by_dtype[key] = (
            self.product_flops_by_dtype.get(key, 0.0) + flops)

    def _kernel(self, name: str, flops: float, nbytes: float,
                dtype: torch.dtype) -> None:
        if _in_propagation():
            return
        self._product(flops, dtype)
        self.bytes += nbytes
        k = self.by_kernel.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    # ---- live storages ---------------------------------------------------
    def _free(self, key, nbytes):
        if self._tracked.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, outs, in_keys) -> None:
        for t in outs:
            key = _storage_key(t)
            if key is None or key in in_keys or key in self._tracked:
                continue
            st = t.untyped_storage()
            n = st.nbytes()
            self._tracked[key] = weakref.ref(
                st, lambda _, key=key, n=n: self._free(key, n))
            self.live += n
            if self.live > self.peak:
                self.peak = self.live

    # ---- every ATen operation --------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if _in_propagation():
            return func(*args, **kwargs)
        ns = func.namespace
        mutating = func._schema.is_mutable
        ins = _tensors((args, kwargs))
        key = None
        if not mutating and ns == "aten" and func not in self._views:
            key = _memo_key(func, args, kwargs, ins)
        spec = self._memo.get(key) if key is not None else None
        if spec is not None:
            out = _from_spec(spec)
        else:
            out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        outs = _tensors(out)
        if ns in _COLLECTIVE_NS:
            self._collective(name, args, ins, outs)
            return out
        in_keys = {_storage_key(t) for t in ins}
        if key is not None and spec is None:
            spec = _spec_of(out, in_keys)
            if spec is not None:
                self._memo[key] = spec
            else:
                self._views.add(func)
        self._track(outs, in_keys)
        if name in _NO_KERNEL or ns == "prim":
            return out
        if not mutating and outs and all(_storage_key(t) in in_keys for t in outs):
            return out                        # a view: no kernel, no bytes
        if name in _FILLS or name.rstrip("_") in _FILLS:
            self.bytes += sum(_bytes(t) for t in outs)
            return out
        if name == "copy_":
            self.bytes += _bytes(args[0]) + _bytes(args[1])
            return out
        self.bytes += sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in outs)
        base = name.rstrip("_")
        if base in _PRODUCTS:
            self._product(_product_flops(base, args, outs[0] if outs else None),
                          ins[0].dtype)
        elif base in _TRANSCENDENTAL:
            n = sum(t.numel() for t in outs)
            self.flops += n
            self.transcendentals += n
        elif base in _REDUCTIONS:
            n = ins[0].numel() if ins else 0
            self.flops += n
            if base == "logsumexp":
                self.transcendentals += n
        elif base in _ELEMENTWISE:
            self.flops += sum(t.numel() for t in outs)
        return out

    def _collective(self, name: str, args, ins, outs) -> None:
        kind = _COLLECTIVE_KINDS.get(name)
        if kind is None:            # wait_tensor, autograd wrappers, barriers
            return
        pg = _group_of(args)
        if pg is not None:
            import torch.distributed as dist
            n = pg.size()
            try:
                ranks = dist.get_process_group_ranks(pg)
            except (ValueError, RuntimeError):
                ranks = list(range(n))
        else:
            n, ranks = 2, [0, 1]
        if name in ("allreduce_", "allreduce_coalesced_", "broadcast_"):
            results = ins           # in place
        elif name in ("allgather_", "_allgather_base_", "reduce_scatter_",
                      "_reduce_scatter_base_", "alltoall_base_", "alltoall_",
                      "allgather_into_tensor_coalesced_",
                      "reduce_scatter_tensor_coalesced_"):
            results = _tensors(args[0])
        else:
            results = outs
        rb = sum(_bytes(t) for t in results)
        wire = rb * roofline.wire_factor(kind, n)
        hbm = sum(_bytes(t) for t in ins) + (0 if results is ins else rb)
        self.bytes += hbm
        self.collective_hbm_bytes += hbm
        self.collectives.append({"kind": kind, "op": name, "group_size": n,
                                 "link": roofline.link_of(ranks),
                                 "result_bytes": rb, "wire_bytes": wire})

    def result(self) -> dict:
        coll = roofline.collective_bytes(self.collectives)
        return {
            "flops": self.flops,
            "transcendentals": self.transcendentals,
            "bytes": self.bytes,
            "collective_hbm_bytes": self.collective_hbm_bytes,
            "collective_wire_bytes": coll["wire_bytes"],
            "collective_per_kind": coll["per_kind_wire"],
            "collective_count": coll["per_kind_count"],
            "collective_result_bytes": coll["per_kind_result_bytes"],
            "collective_wire_by_link": coll["wire_by_link"],
            "peak_bytes": self.peak,
            "product_flops": self.product_flops,
            "product_flops_by_dtype": dict(self.product_flops_by_dtype),
            "by_kernel": {k: dict(v) for k, v in self.by_kernel.items()},
        }


def analyze(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` under an :class:`OpCounter`; its
    :meth:`~OpCounter.result`, with ``fn``'s return value under
    ``"out"``."""
    with OpCounter() as c:
        out = fn(*args, **kw)
    res = c.result()
    res["out"] = out
    return res
