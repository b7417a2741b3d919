"""Counts of the work a call dispatches: the port's counterpart of the
reference's `roofline/hlo_parse.py`.

The port has no compiled HLO to parse, so it counts the aten ops a call
dispatches, under one dispatch mode (`OpCounter`):

- `dot_flops`: the formulas of `torch.utils.flop_counter` (2·M·N·K a
  product: mm, bmm, addmm, baddbmm, convolutions, attention), forward and
  backward, an op without one counted through its decomposition, as
  `FlopCounterMode` counts;
- `hbm_bytes`: the operand and result bytes of every op, skipping views
  and ops that move no data (`view`, `_unsafe_view`, `t`, `transpose`,
  `expand`, `detach`, allocations, queries of metadata that return no
  tensor, ...), as `hlo_parse.hbm_bytes` skips
  `parameter`/`constant`/`tuple`/`bitcast`; an in-place op reads and
  writes its target, a `copy_` reads its source and writes its target;
- `collectives`: the bytes of copies between two distinct accelerator
  devices, by kind ("device-to-device": 0 on one device), and the
  collectives of an SPMD step (`torch.distributed._functional_collectives`
  ops, which DTensor issues), under `hlo_parse.COLLECTIVES`' names
  ("all-reduce", "all-gather", "reduce-scatter", "all-to-all"), each as
  {count, bytes} of its result's bytes on this device.

Every op is counted once, as eager PyTorch runs it: nothing is fused, so
`hbm_bytes` is the traffic of the unfused plain path (the reference's HLO
count sees XLA's fusions). The hand-written kernels are invisible to the
dispatcher, so a counted call runs the plain path (`use_flash=False`), the
same work the reference's HLO counts.

An SPMD call on DTensors (the dry run, `launch/dryrun.py`) is counted per
device: only the ops on this rank's local blocks, which DTensor issues
under the counter, are counted; the DTensor-level call and the
global-shape ops DTensor runs to propagate shapes are not. On fake
tensors, `count(..., live=True)` also follows every storage the call
allocates and reports the peak of those alive at once (`temp_bytes`, less
the result). A data-dependent test of a fake tensor (`bool(t)`, a while
loop's condition) cannot be answered; the counter answers the first True
and every later one False, so such a loop counts one pass, as
`hlo_parse._multipliers` weighs a while loop of unknown trip count, and
the count says how many tests it answered (`data_dependent_tests`).

`record` runs a function under `FakeTensorMode` (meta-backed tensors that
hold no memory) wherever it allows, so gemma-7b counts at full depth in
seconds; a function that needs data (`.item()`, a size that depends on
values) is counted on real tensors instead, on the card, where the peak
memory is measured too.
"""
from __future__ import annotations

import collections
import contextlib
import json
import pathlib
import threading
import weakref

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten
# ops that move no data beyond what a view or an allocation does
_NO_TRAFFIC = {
    aten.detach, aten.lift_fresh, aten.empty, aten.empty_strided,
    aten.empty_like, aten.new_empty, aten.new_empty_strided,
    aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
    aten.is_nonzero,
}
# queries of metadata that FlopCounterMode leaves alone
_METADATA = {
    aten.sym_is_contiguous.default, aten.is_contiguous.default,
    aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default,
    aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
    aten.storage_offset.default, aten.sym_storage_offset.default,
    aten.numel.default, aten.sym_numel.default, aten.dim.default,
    torch.ops.prim.layout.default,
}
# torch's functional collectives, by the reference's HLO names
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
# ops with no DTensor sharding rule, run replicated in an SPMD count
_REPLICATED = (aten.searchsorted.Tensor, aten.log_sigmoid_forward.default,
               aten.log_sigmoid_backward.default)
_DATA_TESTS = {aten._local_scalar_dense.default, aten.is_nonzero.default}
_FLOPS = FlopCounterMode(display=False).flop_registry
_LOCAL = threading.local()      # >0 while DTensor propagates shapes


def _tensors(tree) -> list:
    return [x for x in _pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _accelerator(d: torch.device) -> bool:
    return d.type not in ("cpu", "meta")


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:             # a build without torch.distributed
        return None
    return DTensor


def _propagating() -> bool:
    return getattr(_LOCAL, "depth", 0) > 0


@contextlib.contextmanager
def _uncounted():
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1


@contextlib.contextmanager
def spmd_counting():
    """Make DTensor's own bookkeeping invisible to the counter while in the
    block: the global-shape ops its sharding propagation runs on fake
    tensors are not counted, and the index arithmetic of a strided shard's
    layout (`_StridedShard.local_shard_size_and_offset`, which builds
    small tensors and reads them back) runs outside any fake mode, as it
    must to be answered. A masked partial (a gather from a block of the
    vocabulary) that is reduced twice compares its two masks with
    `torch.equal`, which a fake tensor cannot answer; on fake masks the
    comparison is skipped (both come from the same index). The ops DTensor
    has no sharding rule for (`_REPLICATED`) run replicated: their DTensor
    operands are all-gathered first, as the fallback DTensor ships
    (`replicate_op_strategy`) does."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._ops._mask_buffer import MaskBuffer
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._ops.utils import replicate_op_strategy
    from torch.distributed.tensor._redistribute import _gen_transform_infos
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    prop = ShardingPropagator._propagate_tensor_meta_non_cached
    strided = _StridedShard.__dict__["local_shard_size_and_offset"]
    static = isinstance(strided, staticmethod)
    raw = strided.__func__ if static else strided

    def layout(*args, **kwargs):
        with unset_fake_temporarily(), _uncounted():
            return raw(*args, **kwargs)

    def shapes_only(self, *args, **kwargs):
        with _uncounted():
            return prop(self, *args, **kwargs)
    materialize = MaskBuffer.materialize_mask

    def fake_mask(self, mask):
        if self.refcount and _is_fake(mask):
            self.refcount += 1
            return
        materialize(self, mask)
    ShardingPropagator._propagate_tensor_meta_non_cached = shapes_only
    _StridedShard.local_shard_size_and_offset = \
        staticmethod(layout) if static else layout
    MaskBuffer.materialize_mask = fake_mask
    propagator = DTensor._op_dispatcher.sharding_propagator
    added = [op for op in _REPLICATED
             if op not in propagator.op_strategy_funcs]
    for op in added:
        propagator.register_op_strategy(op, replicate_op_strategy)
    try:
        yield
    finally:
        for op in added:
            propagator.op_strategy_funcs.pop(op, None)
        # cached rules hold masked partials whose masks are this call's
        # fake tensors: no later call may reuse them
        propagator.propagate_op_sharding.cache_clear()
        ShardingPropagator._propagate_tensor_meta_cached.cache_clear()
        _gen_transform_infos.cache_clear()
        torch._C._clear_DTensor_sharding_propagator_cache()
        ShardingPropagator._propagate_tensor_meta_non_cached = prop
        _StridedShard.local_shard_size_and_offset = strided
        MaskBuffer.materialize_mask = materialize


class OpCounter(TorchDispatchMode):
    """Counts what every op on this device's tensors does: dot FLOPs,
    operand and result bytes of every op that moves data (`hbm_bytes`),
    bytes copied between two distinct accelerator devices and collectives
    (`collectives`); with `live`, the peak bytes of the storages the call
    allocates that are alive at once (`peak_live`). DTensor-level calls
    pass through to DTensor, whose local ops come back here."""

    def __init__(self, live: bool = False):
        super().__init__()
        self.dot_flops = 0.0
        self.hbm_bytes = 0
        self.collectives: dict = collections.defaultdict(
            lambda: {"count": 0, "bytes": 0.0})
        self.data_dependent_tests = 0
        self.live = live
        self.live_bytes = self.peak_live = 0
        self._seen: set = set()
        self._decomposing = 0
        self._dtensor = _dtensor_type()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._dtensor is not None and any(
                issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        if func in _METADATA or _propagating():
            return func(*args, **kwargs)
        if func in _DATA_TESTS and _is_fake(args[0]):
            self.data_dependent_tests += 1
            return self.data_dependent_tests == 1
        if func is not torch.ops.prim.device.default:
            self._decomposing += 1
            try:
                with self:
                    out = func.decompose(*args, **kwargs)
            finally:
                self._decomposing -= 1
            if out is not NotImplemented:
                self._traffic(func, args, kwargs, out)
                return out
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in _FLOPS:
            self.dot_flops += _FLOPS[packet](*args, **kwargs, out_val=out)
        self._traffic(func, args, kwargs, out)
        return out

    def _traffic(self, func, args, kwargs, out) -> None:
        if self._decomposing:
            return
        packet = func.overloadpacket
        outs = _tensors(out)
        if self.live:
            for t in outs:
                self._allocated(t)
        if func.is_view or packet in _NO_TRAFFIC:
            return
        ins = _tensors((args, kwargs))
        if not outs:                    # a query of metadata (prim.device)
            return
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVE_KIND.get(packet.__name__)
            if kind is not None:
                c = self.collectives[kind]
                c["count"] += 1
                c["bytes"] += sum(_nbytes(t) for t in outs)
            return
        if packet is aten.copy_:
            dst, src = args[0], args[1]
            moved = _nbytes(dst)
            self.hbm_bytes += _nbytes(src) + moved
            self._cross(src.device, dst.device, moved)
            return
        if packet is aten._to_copy and ins and outs:
            self._cross(ins[0].device, outs[0].device, _nbytes(outs[0]))
        self.hbm_bytes += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live_bytes += n
        self.peak_live = max(self.peak_live, self.live_bytes)
        weakref.finalize(st, self._freed, key, n)

    def _freed(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live_bytes -= n

    def _cross(self, src: torch.device, dst: torch.device, n: int) -> None:
        if src != dst and _accelerator(src) and _accelerator(dst):
            c = self.collectives["device-to-device"]
            c["count"] += 1
            c["bytes"] += n


def local_tensor(t):
    """This device's block of `t` (a DTensor's local tensor itself), else
    `t`."""
    dt = _dtensor_type()
    return t._local_tensor if dt is not None and isinstance(t, dt) else t


def _unique_bytes(tree) -> int:
    seen, total = set(), 0
    for t in _tensors(tree):
        t = local_tensor(t)
        if id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    return total


def _storages(tree) -> set:
    return {id(local_tensor(t).untyped_storage()) for t in _tensors(tree)}


def count(fn, *args, live: bool = False, **kwargs) -> dict:
    """Run fn(*args, **kwargs) under the counter: dot FLOPs, HBM bytes,
    collectives by kind, argument and result bytes (of this device's
    blocks where they are DTensors), and, where the call runs on a CUDA
    device (real tensors), its peak memory (`peak_bytes`, else None) and
    the temporaries above arguments and results (`temp_bytes`); with
    `live` on fake tensors, `temp_bytes` is the peak of the storages the
    call allocates alive at once, less the results it allocated.
    `alias_bytes` are the results that are arguments written in place."""
    dev = next((t.device for t in _tensors((args, kwargs))
                if t.device.type == "cuda" and not _is_fake(t)), None)
    if dev is not None:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    arg_bytes = _unique_bytes((args, kwargs))
    spmd = spmd_counting() if any(
        local_tensor(t) is not t for t in _tensors((args, kwargs))) \
        else contextlib.nullcontext()
    with spmd, OpCounter(live=live) as ops:
        out = fn(*args, **kwargs)
    out_bytes = _unique_bytes(out)
    # results that are arguments written in place (an optimizer step's
    # parameters, a decode step's cache): allocated before the call
    alias_bytes = _unique_bytes([t for t in _tensors(out) if id(
        local_tensor(t).untyped_storage()) in _storages((args, kwargs))])
    peak = temp = None
    if dev is not None:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        temp = max(peak - before - out_bytes, 0)
    elif live:
        temp = max(ops.peak_live - (out_bytes - alias_bytes), 0)
    return dict(dot_flops=float(ops.dot_flops),
                hbm_bytes=float(ops.hbm_bytes),
                collectives={k: dict(v) for k, v in ops.collectives.items()},
                arg_bytes=arg_bytes, out_bytes=out_bytes,
                alias_bytes=alias_bytes,
                peak_bytes=peak, temp_bytes=temp,
                data_dependent_tests=ops.data_dependent_tests, out=out)


def dot_flops(fn, *args, **kwargs) -> float:
    return count(fn, *args, **kwargs)["dot_flops"]


def hbm_bytes(fn, *args, **kwargs) -> float:
    return count(fn, *args, **kwargs)["hbm_bytes"]


def collective_bytes(fn, *args, **kwargs) -> dict:
    return count(fn, *args, **kwargs)["collectives"]


def fake_mode():
    """`FakeTensorMode`: tensors made inside it carry shape, dtype and
    device and hold no memory, so a full-width model is built and counted
    on any host."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def main_dtype(args) -> str:
    """The floating dtype holding most of the arguments' bytes."""
    by = collections.Counter()
    for t in _tensors(args):
        if t.is_floating_point():
            by[str(t.dtype).removeprefix("torch.")] += _nbytes(
                local_tensor(t))
    return by.most_common(1)[0][0] if by else "float32"


def record(arch: str, shape: str, fn, *args, out_dir=None, mesh: str = "1",
           n_devices: int = 1, **extra) -> dict:
    """The record `analysis.analyze` reads, of one call fn(*args): its
    counts, which are one device's (the whole call's on one device, this
    rank's on DTensors), `dtype` (the arguments' main floating dtype
    unless given) and `extra` (e.g. a `model_flops_per_device` for a
    workload cut from its cell, a `device`); written to
    `<out_dir>/<arch>_<shape>.json` when `out_dir` is given. Build `args`
    inside `fake_mode()` to count without memory."""
    c = count(fn, *args)
    rec = dict(arch=arch, shape=shape, mesh=mesh, n_devices=n_devices,
               dtype=extra.pop("dtype", main_dtype(args)),
               dot_flops_per_device=c["dot_flops"],
               hbm_bytes_per_device=c["hbm_bytes"],
               collectives=c["collectives"], arg_bytes=c["arg_bytes"],
               out_bytes=c["out_bytes"], temp_bytes=c["temp_bytes"] or 0,
               peak_bytes=c["peak_bytes"], **extra)
    if out_dir is not None:
        path = pathlib.Path(out_dir)
        path.mkdir(parents=True, exist_ok=True)
        (path / f"{arch}_{shape}.json").write_text(json.dumps(rec, indent=1))
    return rec
