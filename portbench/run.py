"""Run one cell of BENCHMARK.json once on one CUDA device; print its result.

    python3 -m portbench.run --workload lgd.mixed.c8 --seed 7 --seconds 30 \
        --trace 0

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `compared`: each number the comparison with the reference made,
with its limit, also the last lines of standard error. Exits 2 without a
CUDA device, 3 if JAX or the JAX package was loaded; prints no result then.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# every cache at a fixed path inside the checkout (the kernels' own build
# directory is src/repro_torch/_build, also inside it); one thread a pool
CACHE = ROOT / ".portbench_cache"
ENV = {"TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions"),
       "TRITON_CACHE_DIR": str(CACHE / "triton"),
       "CUDA_CACHE_PATH": str(CACHE / "cuda"),
       "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
       "OPENBLAS_NUM_THREADS": "1"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--data-seed", type=int, default=None,
                    help="another dataset than the configuration's "
                         "data_seed: a check of the comparison on other "
                         "data, not a run of the cell")
    args = ap.parse_args(argv)
    os.environ.update(ENV)
    from . import harness, program
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(args.workload, bench)
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    program.import_port()
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START, data_seed=args.data_seed)
    bad = harness.banned_modules()
    if bad:
        print("portbench: JAX or the JAX package was loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    print(json.dumps(res), flush=True)
    for name, v in res["compared"].items():
        lim = (f"limit {v['limit']}" if "limit" in v
               else f"at least {v['min']}")
        print(f"compared {name} {v['value']} {lim}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
