"""Async, atomic, resumable checkpointing.

The port of the reference's `train/checkpoint.py`, in its layout:

    <dir>/step_000000123/
        manifest.json        # step, leaf count, structure, shapes, dtypes
        arrays.npz           # leaves as leaf_0, leaf_1, ... (numpy)
    <dir>/LATEST             # atomic pointer file (rename-into-place)

Leaves are numbered in `jax.tree_util.tree_flatten`'s order (dict keys
sorted, `pytree.leaves`), so a checkpoint of an f32 tree written by either
package restores into the other. bf16 tensors, which numpy has no type
for, are stored as their 16-bit patterns (int16) with "bfloat16" in the
manifest, and restored by view.

Guarantees:
- atomicity: writes go to step_XXX.tmp-<pid>, then are renamed; LATEST is
  updated last, so a crash mid-write never corrupts resume state;
- async: `save()` copies to host memory synchronously and serializes on a
  daemon thread; `wait()` joins before the next save;
- retention: keep the newest `keep` checkpoints.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch

from .. import pytree


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a copy); bf16 as its bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().copy()
    return np.asarray(leaf)


def _structure(tree) -> object:
    if isinstance(tree, list):
        return [_structure(item) for item in tree]
    return ({k: _structure(tree[k]) for k in sorted(tree)}
            if isinstance(tree, dict) else "*")


def _like(ref, arr: np.ndarray):
    """`arr` restored as `ref` holds it: a tensor of ref's dtype on ref's
    device, or the array itself where ref is not a tensor."""
    if not isinstance(ref, torch.Tensor):
        return arr
    if ref.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
            and arr.dtype.kind != "f":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(ref.device)
    return torch.from_numpy(np.array(arr)).to(device=ref.device,
                                              dtype=ref.dtype)


class Checkpointer:
    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False) -> None:
        self.wait()
        leaves = pytree.leaves(tree)
        host = [_to_host(x) for x in leaves]     # device -> host snapshot
        dtypes = ["bfloat16" if isinstance(x, torch.Tensor)
                  and x.dtype == torch.bfloat16 else str(a.dtype)
                  for x, a in zip(leaves, host)]
        structure = json.dumps(_structure(tree))

        def _write():
            tmp = self.dir / f"step_{step:09d}.tmp-{os.getpid()}"
            final = self.dir / f"step_{step:09d}"
            tmp.mkdir(parents=True, exist_ok=True)
            np.savez(tmp / "arrays.npz",
                     **{f"leaf_{i}": a for i, a in enumerate(host)})
            manifest = {
                "step": step,
                "n_leaves": len(host),
                "treedef": structure,
                "shapes": [list(a.shape) for a in host],
                "dtypes": dtypes,
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            latest_tmp = self.dir / f".LATEST.tmp-{os.getpid()}"
            latest_tmp.write_text(final.name)
            os.replace(latest_tmp, self.dir / "LATEST")
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(p for p in self.dir.iterdir()
                       if p.is_dir() and p.name.startswith("step_")
                       and ".tmp" not in p.name)
        for old in steps[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # ------------------------------------------------------------------
    def latest_step(self) -> int | None:
        latest = self.dir / "LATEST"
        if not latest.exists():
            return None
        name = latest.read_text().strip()
        if not (self.dir / name / "manifest.json").exists():
            return None
        return int(name.split("_")[1])

    def restore(self, tree_like):
        """Restore into the structure of `tree_like`: a tensor leaf comes
        back with that leaf's dtype and device, any other leaf as the
        stored numpy array. Returns (tree, step)."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        path = self.dir / f"step_{step:09d}"
        refs = pytree.leaves(tree_like)
        with np.load(path / "arrays.npz") as data:
            if len(data.files) != len(refs):
                raise ValueError(f"{path}: {len(data.files)} leaves, the "
                                 f"tree has {len(refs)}")
            out = [_like(ref, data[f"leaf_{i}"])
                   for i, ref in enumerate(refs)]
        return pytree.unflatten(tree_like, out), step
