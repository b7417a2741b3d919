"""STREAK core on PyTorch: index, storage and the block query engine.

- index: SQuadTree (squadtree), identifier codec (ids), Z-order (morton),
  characteristic sets + Blooms (charsets), node selection DP (node_select)
- storage: QuadStore + permutation/numeric indexes (store), dictionary
- engine: Query AST (query), planner, APS (aps), block executor (executor),
  top-k (topk), spatial join phases (spatial_join), query shapes (shapes),
  shard views (shard), deadlines (fault)
"""
from .executor import ExecConfig, ExecStats, StreakEngine  # noqa: F401
from .fault import QueryDeadline  # noqa: F401
from .join import Relation  # noqa: F401
from .policy import BackendPolicy  # noqa: F401
from .query import Query, Ranking, SpatialFilter, TriplePattern, Var  # noqa: F401
from .store import QuadStore, build_store  # noqa: F401

__all__ = [
    "BackendPolicy", "ExecConfig", "ExecStats", "Query", "QuadStore",
    "QueryDeadline", "Ranking", "Relation", "SpatialFilter", "StreakEngine",
    "TriplePattern", "Var", "build_store",
]
