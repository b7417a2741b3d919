"""Counts of the work a call dispatches: the port's counterpart of the
reference's `roofline/hlo_parse.py`.

The port has no compiled HLO to parse, so it counts the aten ops a call
dispatches, under two dispatch modes at once:

- `dot_flops`: `torch.utils.flop_counter.FlopCounterMode`, 2·M·N·K a
  product (mm, bmm, addmm, baddbmm, convolutions, attention), forward and
  backward;
- `hbm_bytes`: the operand and result bytes of every op, skipping views
  and ops that move no data (`view`, `_unsafe_view`, `t`, `transpose`,
  `expand`, `detach`, allocations, queries of metadata that return no
  tensor, ...), as `hlo_parse.hbm_bytes` skips
  `parameter`/`constant`/`tuple`/`bitcast`; an in-place op reads and
  writes its target, a `copy_` reads its source and writes its target;
- `collectives`: the bytes of copies between two distinct accelerator
  devices, by kind ("device-to-device"): 0 on one device.

Every op is counted once, as eager PyTorch runs it: nothing is fused, so
`hbm_bytes` is the traffic of the unfused plain path (the reference's HLO
count sees XLA's fusions). The hand-written kernels are invisible to the
dispatcher, so a counted call runs the plain path (`use_flash=False`), the
same work the reference's HLO counts.

`record` runs a function under `FakeTensorMode` (meta-backed tensors that
hold no memory) wherever it allows, so gemma-7b counts at full depth in
seconds; a function that needs data (`.item()`, a size that depends on
values) is counted on real tensors instead, on the card, where the peak
memory is measured too.
"""
from __future__ import annotations

import collections
import json
import pathlib

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


def _tensors(tree) -> list:
    return [x for x in _pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _accelerator(d: torch.device) -> bool:
    return d.type not in ("cpu", "meta")


class OpCounter(TorchDispatchMode):
    """Sums the operand and result bytes of every op that moves data
    (`hbm_bytes`) and the bytes copied between two distinct accelerator
    devices (`collectives`)."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.collectives: dict = collections.defaultdict(
            lambda: {"count": 0, "bytes": 0.0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.is_view or packet in _NO_TRAFFIC:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not outs:                    # a query of metadata (prim.device)
            return out
        if packet is aten.copy_:
            dst, src = args[0], args[1]
            moved = _nbytes(dst)
            self.hbm_bytes += _nbytes(src) + moved
            self._cross(src.device, dst.device, moved)
            return out
        if packet is aten._to_copy and ins and outs:
            self._cross(ins[0].device, outs[0].device, _nbytes(outs[0]))
        self.hbm_bytes += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)
        return out

    def _cross(self, src: torch.device, dst: torch.device, n: int) -> None:
        if src != dst and _accelerator(src) and _accelerator(dst):
            c = self.collectives["device-to-device"]
            c["count"] += 1
            c["bytes"] += n


def _unique_bytes(tree) -> int:
    seen, total = set(), 0
    for t in _tensors(tree):
        if id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    return total


def count(fn, *args, **kwargs) -> dict:
    """Run fn(*args, **kwargs) under the counters: dot FLOPs, HBM bytes,
    collectives by kind, argument and result bytes, and, where the call
    runs on a CUDA device (real tensors), its peak memory (`peak_bytes`, else None) and
    the temporaries above arguments and results (`temp_bytes`)."""
    from torch._subclasses.fake_tensor import is_fake
    dev = next((t.device for t in _tensors((args, kwargs))
                if t.device.type == "cuda" and not is_fake(t)), None)
    if dev is not None:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with FlopCounterMode(display=False) as flops, OpCounter() as ops:
        out = fn(*args, **kwargs)
    out_bytes = _unique_bytes(out)
    peak = temp = None
    if dev is not None:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        temp = max(peak - before - out_bytes, 0)
    return dict(dot_flops=float(flops.get_total_flops()),
                hbm_bytes=float(ops.hbm_bytes),
                collectives={k: dict(v) for k, v in ops.collectives.items()},
                arg_bytes=_unique_bytes((args, kwargs)), out_bytes=out_bytes,
                peak_bytes=peak, temp_bytes=temp, out=out)


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


def _main_dtype(args) -> str:
    """The floating dtype holding most of the arguments' bytes."""
    by = collections.Counter()
    for t in _tensors(args):
        if t.is_floating_point():
            by[str(t.dtype).removeprefix("torch.")] += _nbytes(t)
    return by.most_common(1)[0][0] if by else "float32"


def record(arch: str, shape: str, fn, *args, out_dir=None, mesh: str = "1",
           n_devices: int = 1, **extra) -> dict:
    """The record `analysis.analyze` reads, of one call fn(*args): its
    counts as per-device figures, `dtype` (the arguments' main floating
    dtype unless given) and `extra` (e.g. a `model_flops_per_device` for a
    workload cut from its cell, a `device`); written to
    `<out_dir>/<arch>_<shape>.json` when `out_dir` is given. Build `args`
    inside `fake_mode()` to count without memory."""
    c = count(fn, *args)
    rec = dict(arch=arch, shape=shape, mesh=mesh, n_devices=n_devices,
               dtype=extra.pop("dtype", _main_dtype(args)),
               dot_flops_per_device=c["dot_flops"] / n_devices,
               hbm_bytes_per_device=c["hbm_bytes"] / n_devices,
               collectives=c["collectives"], arg_bytes=c["arg_bytes"],
               out_bytes=c["out_bytes"], temp_bytes=c["temp_bytes"] or 0,
               peak_bytes=c["peak_bytes"], **extra)
    if out_dir is not None:
        path = pathlib.Path(out_dir)
        path.mkdir(parents=True, exist_ok=True)
        (path / f"{arch}_{shape}.json").write_text(json.dumps(rec, indent=1))
    return rec

