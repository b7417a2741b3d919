"""STREAK on PyTorch and CUDA: top-k SPARQL with spatial filters.

The port of the `repro` package (JAX on a TPU) to PyTorch on an NVIDIA
H100. It exports `repro`'s public surface:

    from repro_torch import (QuadStore, build_store, StreakEngine, ExecConfig,
                             BackendPolicy, Query, TriplePattern, Relation)

    store = build_store(quads, dictionary, geometry_predicate, geometries)
    engine = StreakEngine(store, ExecConfig(policy=BackendPolicy()))
    scores, rows, stats = engine.execute(query)

The engine runs on CUDA unless it is given ``device="cpu"``; its kernels are
hand-written CUDA C++ in `csrc/`, built with nvcc at first use, each with a
plain torch version in `kernels/ref.py` that the CPU path runs.
"""
from .core import (BackendPolicy, ExecConfig, ExecStats, FaultPlan,
                   FaultRule, Query, QuadStore, QueryDeadline, Ranking,
                   Relation, ShardedQuadStore, SpatialFilter, StreakEngine,
                   TriplePattern, Var, build_store, shard_store)

__all__ = [
    "BackendPolicy", "ExecConfig", "ExecStats", "FaultPlan", "FaultRule",
    "Query", "QuadStore", "QueryDeadline", "Ranking", "Relation",
    "ShardedQuadStore", "SpatialFilter", "StreakEngine", "TriplePattern",
    "Var", "build_store", "shard_store",
]
