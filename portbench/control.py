"""The comparison's controls: the reference, one precision down, in the
program's place.

The configurations state float64 ranking values (scores are sums of the
numeric literals' doubles) over float32 stored points. Two controls answer
each request with the reference computed one precision below what is
stated, and are held to the same comparison as the program:

- `scores`: float32 values and sums, and float32 distances;
- `dist`: float64 values and sums, and bfloat16 distances (points,
  differences, squares, sums and roots rounded).

Each has to come out not correct; their readings are the upper ones that
`PERF.md` sets the limits between.

    python3 -m portbench.control --workload lgd.mixed.c8 --kind dist \
        --seeds 11 12 13 --requests 240

reads, for each seed, the first `--requests` requests of the cell's
traffic (as many as a run checks) at the cell's own sizes, and prints one
JSON line a seed with the numbers compared. It needs no card and runs no
part of the program.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import datagen, harness, program, reference, traffic

KINDS = {"scores": dict(dtype=np.float32),
         "dist": dict(dtype=np.float64, dist_bf16=True)}


def control_answers(ds, reqs: list, kind: str = "scores",
                    root=harness.ROOT) -> list:
    """(request, scores, keys) of each request, answered by the reference
    one precision down as the program would serve it (its template's
    shape's `served`: for the top-k join, its rows within the distance,
    best first, the first k)."""
    low = reference.Reference(ds, **KINDS[kind])
    shapes = program.shapes_of(ds.templates, root)
    out = []
    for key, group in harness.groups(ds, [(r,) for r in reqs],
                                     shapes).items():
        tpl = ds.templates[key[0]]
        group = [r for r, in group]
        for r, (scores, keys) in zip(group, shapes[tpl.shape].served(
                low, tpl, group)):
            out.append((r, scores, keys))
    return out


def readings(cell, seed: int, n: int, scale: dict | None = None,
             kind: str = "scores") -> dict:
    """The control's numbers compared for `seed`: its answers to the
    first `n` requests of the cell's traffic."""
    cfg, mix = cell.config, cell.mix
    ds = datagen.make(dict(cfg, scale=scale or cfg["scale"]), seed,
                      cell.root)
    seq = traffic.requests(mix, cfg, ds.templates, seed)
    reqs = [next(seq) for _ in range(n)]
    return harness.compare(ds, control_answers(ds, reqs, kind, cell.root),
                           0, root=cell.root)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", choices=sorted(KINDS), default="scores")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(cell, seed, args.requests, kind=args.kind)
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed, "requests": args.requests,
                          "correct": harness.is_correct(got),
                          "seconds": time.perf_counter() - t0,
                          "compared": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
