"""Unified backend policy: one knob surface for every dispatchable stage.

`BackendPolicy` names a backend for each stage of the engine in one frozen
dataclass with a single ``resolve()`` that validates every stage against its
registry and pins the "auto" choices:

    ExecConfig(policy=BackendPolicy(join="fused", descend="kernel"))

Resolution happens once per config (`ExecConfig.__post_init__`) and the
resolved stages are stamped onto the `QueryPlan`, so the per-block hot
paths read plain strings.

A "kernel" backend runs on the engine's device: the CUDA kernel on a CUDA
device, its plain torch version on the CPU.
"""
from __future__ import annotations

import dataclasses

# fused partial-width modes: "fixed" = the static min(max(k, 64), batch_cols)
# floor; "auto" = the per-engine EWMA KcapTuner (spatial_join.KcapTuner)
KCAP_MODES = ("fixed", "auto")


@dataclasses.dataclass(frozen=True)
class BackendPolicy:
    """Backend selection for every dispatchable engine stage.

    Each field names a registry entry (all accept "auto"):

    - ``join``:    Phase-3 MBR distance join — spatial_join.JOIN_BACKENDS
                   ("auto" | "numpy" | "kernel" | "fused")
    - ``impl``:    relational join primitive — core/join.JOIN_IMPLS
                   ("auto" | "merge" | "looped")
    - ``rank``:    merge-join rank pass — kernels/ops.RANK_BACKENDS
                   ("auto" | "numpy" | "kernel")
    - ``probe``:   Bloom CS probes — charsets.PROBE_BACKENDS
                   ("auto" | "numpy" | "kernel")
    - ``descend``: Phase-1 candidate-node traversal —
                   squadtree.DESCEND_BACKENDS ("auto" | "numpy" | "kernel")
    - ``kcap``:    fused partial-width mode — KCAP_MODES ("fixed" | "auto")

    Every backend of a stage gives the same answer as every other backend of
    the same stage, so the policy is purely a performance choice.
    """
    join: str = "auto"
    impl: str = "auto"
    rank: str = "auto"
    probe: str = "auto"
    descend: str = "auto"
    kcap: str = "fixed"

    def resolve(self) -> "BackendPolicy":
        """Validate every stage and pin the "auto" choices.

        Returns a policy with no "auto" left (idempotent). Raises ValueError
        naming the stage on any unknown backend.

        Resolution also consults the fault layer's circuit breakers
        (core/fault.demote_stage): while a fault plan is installed or a
        watchdog armed, a stage whose resolved backend sits on a
        breaker-open op resolves to its safe fallback here, at plan time,
        counted in `FaultStats.policy_demotions`. Otherwise (the normal
        case) demotion is a no-op, so a kernel stage never moves to the
        host behind the caller's back.
        """
        from ..kernels import ops
        from . import charsets, fault, spatial_join, squadtree
        from .join import resolve_join_impl

        if self.kcap not in KCAP_MODES:
            raise ValueError(f"unknown kcap mode {self.kcap!r} "
                             f"(expected one of {KCAP_MODES})")
        return BackendPolicy(
            join=fault.demote_stage(
                "join", spatial_join.resolve_join_backend(self.join)),
            impl=resolve_join_impl(self.impl),
            rank=fault.demote_stage(
                "rank", ops.resolve_rank_backend(self.rank)),
            probe=fault.demote_stage(
                "probe", charsets.resolve_probe_backend(self.probe)),
            descend=fault.demote_stage(
                "descend", squadtree.resolve_descend_backend(self.descend)),
            kcap=self.kcap,
        )

    @property
    def resolved(self) -> bool:
        return "auto" not in (self.join, self.impl, self.rank,
                              self.probe, self.descend)
