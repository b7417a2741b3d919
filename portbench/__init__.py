"""The benchmark of `repro_torch`, the PyTorch and CUDA port of STREAK.

One command runs one cell of BENCHMARK.json once and prints one JSON line:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Each configuration, traffic mix and per-layer metric is a file of its own
(configs/, traffic/, metrics/), found by its name in BENCHMARK.json; a
configuration's generator, where `datagen.GENERATORS` has none of its name,
and each template's query shape are files too (generators/, shapes/).
"""
