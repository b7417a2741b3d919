"""Elastic resharding: survive device loss without restarting training.

The port of the reference's `dist/elastic.py` on the port's mesh types
(`launch/mesh.py`). When a host drops out, the job shrinks the
data-parallel axis (the model axis must keep its size: parameters are
sharded across it), re-derives each tensor's PartitionSpec on the
surviving mesh, and `device_put`s the state over. `respec` also folds away
mesh axes that no longer exist (the "pod" axis when a 2-pod job collapses
to one pod).
"""
from __future__ import annotations

from .. import pytree
from ..launch.mesh import Mesh, NamedSharding, PartitionSpec, device_put


def shrink_mesh(mesh: Mesh, n_lost: int, model_axis: str = "model") -> Mesh:
    """New mesh over the surviving devices, preserving the model axis size.

    Only the non-model axes shrink: with `model` parameters sharded across
    `model_axis`, dropping model shards would lose state. The data axis is
    rounded down to the largest size that fits the surviving device count.
    """
    names = tuple(mesh.axis_names)
    model = int(mesh.shape[model_axis]) if model_axis in names else 1
    alive = int(mesh.devices.size) - int(n_lost)
    rows = max(1, alive // model)
    flat = mesh.devices.reshape(-1)[: rows * model]
    other = tuple(n for n in names if n != model_axis)
    if len(other) == 1:
        shape = (rows, model) if names.index(model_axis) == 1 else (model, rows)
        return Mesh(flat.reshape(shape), names)
    # collapse any extra leading axes (e.g. "pod") into the first data axis
    new_names = (other[-1], model_axis) if model_axis in names else other
    return Mesh(flat.reshape(rows, model), new_names)


def respec(sharding: NamedSharding, new_mesh: Mesh) -> NamedSharding:
    """Re-derive a NamedSharding on `new_mesh`, dropping vanished axes.

    Spec entries may be axis names or tuples of names; names absent from the
    new mesh (a folded "pod" axis) are removed, and an entry left empty
    becomes replication (None).
    """
    alive = set(new_mesh.axis_names)
    new_entries = []
    for entry in sharding.spec:
        if entry is None:
            new_entries.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in alive)
            new_entries.append(kept if kept else None)
        else:
            new_entries.append(entry if entry in alive else None)
    return NamedSharding(new_mesh, PartitionSpec(*new_entries))


def reshard_tree(tree, shardings, new_mesh: Mesh):
    """`device_put` every leaf onto `new_mesh` under its respec'd sharding.

    `shardings` mirrors `tree` (a tree of NamedShardings, e.g. captured
    from the live tensors before the failure). A dimension the new mesh's
    axes do not divide raises `ValueError`, as in the reference.
    """
    return pytree.tree_map(
        lambda x, s: device_put(x, respec(s, new_mesh)), tree, shardings)
