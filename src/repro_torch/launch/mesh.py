"""Device meshes, partition specs and sharded tensors.

The port of the reference's `launch/mesh.py` together with the pieces of
`jax.sharding` it builds on. A `Mesh` is an ndarray of `torch.device`s with
one name per axis; `NamedSharding(mesh, PartitionSpec(...))` says which
mesh axes split which tensor dimension; `device_put(x, sharding)` cuts a
tensor into one block per mesh position, each on that position's device
(a `ShardedTensor`), and `ShardedTensor.gather(device)` puts it back
together.

One difference from jax is deliberate: a mesh may name one device more
than once. That device then holds several positions' blocks, so one card
(or the CPU, in the tests) runs a mesh of any size; results never depend
on placement. jax builds such a mesh but refuses `device_put` onto it.

The reference's `shard_map_compat` has no counterpart: each sharded
function of the port (`serve/retrieval.py`, `kernels/ops.py`) loops over
the mesh positions itself.

    Single pod: (16, 16) = 256 devices, axes ("data", "model").
    Multi-pod:  (2, 16, 16) = 512 devices, axes ("pod", "data", "model").

`devices=None` means every CUDA device, and raises where there is none.
`placeholder_devices(n)` names n positions that hold nothing, for a mesh
that is only laid out, never computed on: the dry run's production
meshes.

The bridge to `torch.distributed.tensor` (DTensor): `device_mesh(mesh)` is
the `DeviceMesh` of the same devices and axes (the data-parallel "pod" and
"data" joined into one dimension), over the default process group
(`fake_process_group(n)` gives one of n ranks that exchanges no data, for
the dry run); `placements` lays a `PartitionSpec` out as DTensor
placements; `to_dtensor` wraps a local block.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import math
import threading

import numpy as np
import torch

_AMBIENT = threading.local()


def _device_array(devices, shape=None) -> np.ndarray:
    flat = list(np.asarray(devices, dtype=object).reshape(-1)) \
        if isinstance(devices, np.ndarray) else list(devices)
    arr = np.empty(len(flat), dtype=object)
    arr[:] = [torch.device(d) for d in flat]
    if shape is None and isinstance(devices, np.ndarray):
        shape = devices.shape
    return arr.reshape(shape if shape is not None else (len(flat),))


class Mesh:
    """Devices laid out on named axes: `devices` an ndarray of
    `torch.device`, `axis_names` one name per axis, `shape` an ordered
    {name: size}. `with mesh:` makes it the ambient mesh (`ambient_mesh`),
    as jax's mesh context does."""

    def __init__(self, devices, axis_names):
        self.devices = _device_array(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) \
                or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs one "
                             f"distinct name per axis, got {self.axis_names}")

    @property
    def shape(self) -> collections.OrderedDict:
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self):
        """Every mesh position, as an index tuple, in row-major order."""
        return itertools.product(*(range(n) for n in self.devices.shape))

    def __enter__(self) -> Mesh:
        stack = getattr(_AMBIENT, "stack", None)
        if stack is None:
            stack = _AMBIENT.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.stack.pop()

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and list(self.devices.flat) == list(other.devices.flat))

    def __repr__(self) -> str:
        axes = ", ".join(f"'{k}': {v}" for k, v in self.shape.items())
        return f"Mesh({axes})"


def ambient_mesh() -> Mesh | None:
    """The mesh of the innermost `with mesh:` block of this thread."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


class PartitionSpec(tuple):
    """One entry a tensor dimension: None (replicated), an axis name, or a
    tuple of axis names (split over their product, the first outermost; a
    tuple of one name is that name, as jax normalises it). Dimensions past
    the last entry are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> tuple:
        """The mesh axes that split dimension `dim`."""
        entry = self[dim] if dim < len(self) else None
        if entry is None:
            return ()
        return tuple(entry) if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A tensor's layout over `mesh`: `spec` names the axes that split each
    dimension. An axis the mesh lacks, or one named twice, raises
    `ValueError`, as jax's does."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)
        used = [a for d in range(len(self.spec)) for a in self.spec.axes(d)]
        for a in used:
            if a not in mesh.axis_names:
                raise ValueError(f"Resource axis: {a} of {self.spec!r} is "
                                 f"not found in mesh: {mesh.axis_names}.")
        if len(set(used)) != len(used):
            raise ValueError(f"{self.spec!r} names a mesh axis twice")

    def parts(self, dim: int) -> int:
        """How many blocks dimension `dim` is cut into."""
        return math.prod(self.mesh.shape[a] for a in self.spec.axes(dim))

    def index(self, pos: tuple, dim: int) -> int:
        """Which of `parts(dim)` blocks of dimension `dim` mesh position
        `pos` holds: its coordinates on the splitting axes, row-major."""
        i = 0
        for a in self.spec.axes(dim):
            ax = self.mesh.axis_names.index(a)
            i = i * self.mesh.devices.shape[ax] + pos[ax]
        return i

    def block_slices(self, shape: tuple, pos: tuple) -> tuple:
        """The slices of a tensor of `shape` that position `pos` holds."""
        out = []
        for dim, n in enumerate(shape):
            step = n // self.parts(dim)
            i = self.index(pos, dim)
            out.append(slice(i * step, (i + 1) * step))
        return tuple(out)

    def check(self, shape: tuple) -> None:
        """Raise `ValueError` where `shape` cannot be laid out so."""
        if len(self.spec) > len(shape):
            raise ValueError(f"{self!r} has {len(self.spec)} entries for a "
                             f"tensor of rank {len(shape)}")
        for dim, n in enumerate(shape):
            parts = self.parts(dim)
            if n % parts:
                raise ValueError(
                    f"One of device_put args was given the sharding of "
                    f"{self!r}, which implies that the global size of its "
                    f"dimension {dim} should be divisible by {parts}, but it "
                    f"is equal to {n} (full shape: {tuple(shape)})")

    def __eq__(self, other) -> bool:
        if not isinstance(other, NamedSharding) or self.mesh != other.mesh:
            return False
        n = max(len(self.spec), len(other.spec))
        return all(self.spec.axes(d) == other.spec.axes(d) for d in range(n))

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec!r})"


class ShardedTensor:
    """A tensor laid out over a mesh: `blocks[pos]` is mesh position pos's
    block, on that position's device; `sharding`, `shape` and `dtype` are
    the whole tensor's."""

    def __init__(self, blocks: np.ndarray, sharding: NamedSharding,
                 shape: tuple, dtype: torch.dtype):
        self.blocks = blocks
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype

    def along(self, axis: str) -> list:
        """The blocks at each position of mesh axis `axis`, every other
        axis at its first position."""
        mesh = self.sharding.mesh
        ax = mesh.axis_names.index(axis)
        pos = [0] * len(mesh.axis_names)
        out = []
        for i in range(mesh.shape[axis]):
            pos[ax] = i
            out.append(self.blocks[tuple(pos)])
        return out

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on `device`."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for pos in self.sharding.mesh.positions():
            out[self.sharding.block_slices(self.shape, pos)] = \
                self.blocks[pos].to(device)
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"sharding={self.sharding!r})")


def device_put(x, sharding: NamedSharding) -> ShardedTensor:
    """`x` (a tensor or a `ShardedTensor`) laid out as `sharding` says: one
    block per mesh position on its device, replicated dimensions whole. A
    dimension that the splitting axes' sizes do not divide raises
    `ValueError`. A block that lands on the device its source lies on is a
    view of it, as `Tensor.to` returns the tensor itself; a `ShardedTensor`
    is gathered on the new mesh's first device and cut again."""
    sharding.check(tuple(x.shape))
    if isinstance(x, ShardedTensor):
        x = x.gather(sharding.mesh.devices.flat[0])
    mesh = sharding.mesh
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for pos in mesh.positions():
        blocks[pos] = x[sharding.block_slices(tuple(x.shape), pos)].to(
            mesh.devices[pos])
    return ShardedTensor(blocks, sharding, tuple(x.shape), x.dtype)


def shard_blocks(x, mesh: Mesh, axis: str) -> list:
    """`x`'s blocks under `P(axis)` on `mesh`, one for each position of
    `axis`: `x`'s own blocks where it is laid out so already, else those of
    `device_put(x, NamedSharding(mesh, P(axis)))` (which raises where the
    axis does not divide dimension 0)."""
    want = NamedSharding(mesh, PartitionSpec(axis))
    if not (isinstance(x, ShardedTensor) and x.sharding == want):
        x = device_put(x, want)
    return x.along(axis)


def _cuda_devices(devices, fn: str) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(f"{fn}: no CUDA device; pass `devices` to build "
                           "a mesh elsewhere")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _make_mesh(shape: tuple, names: tuple, devices: list) -> Mesh:
    if math.prod(shape) > len(devices):
        raise ValueError(f"Number of devices {len(devices)} must be >= the "
                         f"product of mesh_shape {shape}")
    return Mesh(_device_array(devices[:math.prod(shape)], shape), names)


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> Mesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with `multi_pod`, over the first devices of `devices`; fewer
    devices than positions raise `ValueError`, as `jax.make_mesh` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes,
                      _cuda_devices(devices, "make_production_mesh"))


def make_host_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """A small ("data", "model") mesh over the local devices: `data`
    clamped to the device count, `model` to what is left of it."""
    devs = _cuda_devices(devices, "make_host_mesh")
    n = len(devs)
    data = min(data, n)
    model = max(1, min(model, n // data))
    return _make_mesh((data, model), ("data", "model"), devs)


def make_shard_mesh(n_shards: int, devices=None) -> Mesh:
    """1-axis ("shard",) mesh for the Morton-prefix store shards, sized to
    the largest divisor of `n_shards` that fits the device count, so an
    (S, ...) per-shard stack splits evenly: each position then holds
    S / size contiguous shards."""
    devs = _cuda_devices(devices, "make_shard_mesh")
    d = max(k for k in range(1, min(len(devs), n_shards) + 1)
            if n_shards % k == 0)
    return _make_mesh((d,), ("shard",), devs)


def placeholder_devices(n: int) -> list:
    """n mesh positions on the "meta" device: a mesh over them is laid out
    and counted (the dry run), never computed on."""
    return [torch.device("meta")] * n


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """The default process group for the calls inside: rank 0 of
    `world_size` ranks whose collectives move no data (torch's "fake"
    backend), torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_process_group: a process group is already "
                           "initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# mesh axes that every layout of the port splits together (the data-
# parallel axes): the DeviceMesh of a mesh that has both holds them as one
# dimension, which DTensor plans collectives over far faster than over two
JOINED = ("pod", "data")


def _dims(axis_names: tuple) -> list:
    """The DeviceMesh dimensions of a mesh's axes, `JOINED` axes as one:
    [("pod", "data"), ("model",)] for ("pod", "data", "model")."""
    if all(a in axis_names for a in JOINED):
        i = axis_names.index(JOINED[0])
        if axis_names[i:i + len(JOINED)] == JOINED:
            return [(a,) for a in axis_names[:i]] + [JOINED] \
                + [(a,) for a in axis_names[i + len(JOINED):]]
    return [(a,) for a in axis_names]


def device_mesh(mesh: Mesh):
    """The `DeviceMesh` of `mesh` over the default process group, whose
    world size must be `mesh.size`: the same shape and axis names, but the
    `JOINED` axes ("pod", "data") as one dimension named "pod+data"."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = mesh.devices.flat[0].type
    dims = _dims(mesh.axis_names)
    return init_device_mesh(
        "cpu" if dev == "meta" else dev,
        tuple(math.prod(mesh.shape[a] for a in d) for d in dims),
        mesh_dim_names=tuple("+".join(d) for d in dims))


def placements(spec: PartitionSpec, ndim: int, dim_names: tuple) -> list:
    """DTensor placements, one per DeviceMesh dimension of `dim_names`
    (`device_mesh`'s names), of a rank-`ndim` tensor laid out by `spec`:
    `Shard(d)` on each dimension whose axes split tensor dimension d,
    `Replicate()` elsewhere. A tensor dimension split over several
    dimensions takes them in mesh order (the first outermost, as `spec`
    says); a spec that orders them otherwise, or that splits a joined
    dimension's axes apart, raises `ValueError`."""
    from torch.distributed.tensor import Replicate, Shard
    groups = [tuple(n.split("+")) for n in dim_names]
    out = [Replicate() for _ in groups]
    for d in range(ndim):
        axes = spec.axes(d)
        idx, k = [], 0
        while k < len(axes):
            g = next((i for i, grp in enumerate(groups)
                      if axes[k:k + len(grp)] == grp), None)
            if g is None:
                raise ValueError(f"{spec!r}: dimension {d}'s axes {axes} "
                                 f"do not fall on the mesh's {groups}")
            idx.append(g)
            k += len(groups[g])
        if idx != sorted(idx):
            raise ValueError(f"{spec!r}: dimension {d} splits over axes out "
                             f"of mesh order {dim_names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_shape(shape: tuple, sharding: NamedSharding) -> tuple:
    """The block of a tensor of `shape` that each position holds."""
    sharding.check(shape)
    return tuple(n // sharding.parts(d) for d, n in enumerate(shape))


def to_dtensor(local: torch.Tensor, dmesh, sharding: NamedSharding,
               shape: tuple):
    """A DTensor of global `shape` over `dmesh` laid out by `sharding`,
    whose block on this rank is `local`."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(
        local, dmesh, placements(sharding.spec, len(shape),
                                 tuple(dmesh.mesh_dim_names)),
        run_check=False, shape=torch.Size(shape), stride=stride)
