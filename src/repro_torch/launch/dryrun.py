"""Multi-device dry run: what one device of the production mesh holds,
computes and sends, for every (architecture x input-shape) cell.

The port of the reference's `launch/dryrun.py`, which lowers and compiles
each cell with XLA's SPMD partitioner on 512 placeholder host devices. Here
each cell's step runs as rank 0 of a fake process group of 256 or 512
ranks (torch's "fake" backend: collectives move no data) on DTensors laid
out over the (16, 16) or (2, 16, 16) mesh, whose local blocks are fake
tensors (`FakeTensorMode`): no card, no memory. `roofline/op_count` counts
the local ops only: dot FLOPs, HBM bytes, collectives by kind and the
peak of live temporaries. The step runs the plain path (no hand-written
kernel), as the reference's HLO does.

One JSON record a cell goes to `artifacts/dryrun_torch/`, with the
reference's fields (per-device argument, output, temporary and aliased
bytes, FLOPs, HBM and collective bytes) plus `dtype`; with no XLA cost
analysis, `flops_per_device` and `bytes_accessed_per_device` repeat the
dot FLOPs and HBM bytes. `roofline/analysis.load_all(art=...)` reads them:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both]
  PYTHONPATH=src python -m repro_torch.roofline.analysis \\
      --dir artifacts/dryrun_torch --mesh 16x16
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

from ..configs import registry
from ..roofline import op_count
from .cells import build_cell, materialize
from .mesh import (device_mesh, fake_process_group, make_production_mesh,
                   placeholder_devices, placements)

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" \
    / "dryrun_torch"


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.devices.shape)


def _laid_out(out, shardings):
    """The step's outputs redistributed to `shardings` (a tree over the
    outputs; None leaves an output as the step made it), as the
    reference's `out_shardings` make XLA lay them out."""
    from torch.distributed.tensor import DTensor
    if shardings is None:
        return out
    if isinstance(out, (tuple, list)):
        return type(out)(_laid_out(o, s) for o, s in zip(out, shardings))
    if isinstance(out, dict):
        return {k: _laid_out(v, shardings[k]) for k, v in out.items()}
    if isinstance(out, DTensor):
        dm = out.device_mesh
        return out.redistribute(dm, placements(
            shardings.spec, out.ndim, tuple(dm.mesh_dim_names)))
    return out


def count_cell(cell, mesh) -> dict:
    """One device's counts of `cell`'s step on `mesh`: a fake process group
    of `mesh.size` ranks, fake DTensor arguments, the step counted with
    live-bytes tracking (on a one-position mesh, plain fake tensors). The
    group is torn down before this returns."""
    from torch.distributed.tensor.experimental import implicit_replication
    if mesh.size == 1:
        # one device: every block is the whole tensor and nothing is sent,
        # so plain fake tensors count the same work without DTensor
        with op_count.fake_mode():
            return _count(mesh, cell.fn, materialize(cell, fake=True))
    with fake_process_group(mesh.size):
        dmesh = device_mesh(mesh)
        with op_count.fake_mode():
            args = materialize(cell, dmesh=dmesh)
            # plain tensors a step makes (positions, masks, zeros) join the
            # DTensor computation replicated, as jit's constants do
            with implicit_replication():
                return _count(mesh, lambda *a: _laid_out(
                    cell.fn(*a), cell.out_shardings), args)


def _count(mesh, fn, args) -> dict:
    with mesh:
        c = op_count.count(fn, *args, live=True)
    del c["out"]
    c["dtype"] = op_count.main_dtype(args)
    return c


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
             variant: str = "base", mesh=None, art=ART) -> dict:
    """Count one cell on the production mesh (or `mesh`), write its record
    to `art` and return it."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    devices=placeholder_devices(512))
    t0 = time.time()
    cell = build_cell(arch, shape, mesh, variant=variant)
    c = count_cell(cell, mesh)
    rec = {
        "arch": arch, "shape": shape, "variant": variant,
        "mesh": mesh_name(mesh), "n_devices": int(mesh.size),
        "compile_s": round(time.time() - t0, 1),
        # every figure is one device's (rank 0's blocks)
        "arg_bytes": int(c["arg_bytes"]),
        "out_bytes": int(c["out_bytes"]),
        "temp_bytes": int(c["temp_bytes"]),
        "alias_bytes": int(c["alias_bytes"]),
        "flops_per_device": c["dot_flops"],
        "bytes_accessed_per_device": c["hbm_bytes"],
        "dot_flops_per_device": c["dot_flops"],
        "hbm_bytes_per_device": c["hbm_bytes"],
        "collectives": c["collectives"],
        "dtype": c["dtype"],
        "data_dependent_tests": c["data_dependent_tests"],
    }
    if c["data_dependent_tests"]:
        rec["assumption"] = ("a loop whose trip count depends on data "
                             "counts one pass")
    if verbose:
        peak = rec["arg_bytes"] + rec["temp_bytes"] + rec["out_bytes"] \
            - rec["alias_bytes"]
        print(f"[{arch} x {shape} x {rec['mesh']}] counted in "
              f"{rec['compile_s']}s; per-device: args "
              f"{rec['arg_bytes']/2**30:.2f} GiB, temps "
              f"{rec['temp_bytes']/2**30:.2f} GiB, peak ~{peak/2**30:.2f} GiB;"
              f" flops {rec['flops_per_device']:.3e}; collective bytes "
              f"{sum(v['bytes'] for v in rec['collectives'].values()):.3e}",
              flush=True)
    if art is not None:
        art = pathlib.Path(art)
        art.mkdir(parents=True, exist_ok=True)
        suffix = "" if variant == "base" else f"__{variant}"
        out = art / f"{arch}__{shape}__{rec['mesh']}{suffix}.json"
        out.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="both")
    ap.add_argument("--variant", default="base",
                    choices=["base", "opt", "opt2"])
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(ART), help="the records' directory")
    args = ap.parse_args(argv)
    art = pathlib.Path(args.out)

    from .cells import variants
    cells = registry.all_cells() if args.all else None
    if cells is None:
        archs = [args.arch] if args.arch else list(registry.ARCHS)
        cells = []
        for a in archs:
            shapes = [args.shape] if args.shape else list(
                registry.get(a).shapes)
            cells += [(a, s) for s in shapes]
    cells = [c for c in cells if args.variant in variants(*c)]

    pods = {"off": [False], "on": [True], "both": [False, True]}[
        args.multi_pod]
    failures = []
    suffix = "" if args.variant == "base" else f"__{args.variant}"
    for arch, shape in cells:
        for mp in pods:
            name = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}{suffix}"
            if args.skip_existing and (art / f"{name}.json").exists():
                print(f"[skip] {name}")
                continue
            try:
                run_cell(arch, shape, mp, variant=args.variant, art=art)
            except Exception:
                failures.append(name)
                print(f"[FAIL] {name}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print(f"\nall {len(cells) * len(pods)} dry-run cells counted OK")


if __name__ == "__main__":
    main()
