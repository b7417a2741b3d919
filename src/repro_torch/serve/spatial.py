"""Multi-tenant spatial-query serving: continuous batching over STREAK.

A fixed pool of `max_slots` slots, each holding one query's `QueryCursor`;
waiting requests claim free slots, every engine step advances EVERY active
slot by one driver block, and a query that θ-terminates (or exhausts its
driver scan) releases its slot mid-flight for the next queued request —
continuous batching, with "one decoded token" replaced by "one driver
block".

What batches across tenants per step:

- **Phases 1-2** — every slot's `begin_block()` request is pooled into ONE
  `candidate_nodes` call (per-block driven-CS sets + per-block distances;
  on the kernel route one `tree_descend` launch per CS group, whose rows
  come from every tenant in the group) and ONE `select_batch` call with a
  stacked per-row cost matrix.
- **Phase 3** — with the fused join backend, every slot's streaming join
  registers with a `_FusedJoinBatcher`; one `fused_stream_join_multi` run
  then launches all live queries' driver blocks in shared `fused_topk_join`
  launches with per-row (distance, θ, query-id) state, each query's partial
  results feeding back into its own TopK between launches.

θ pruning is sound at any batching granularity, so per-query results equal
serial `StreakEngine.execute` runs exactly.

Crash isolation: each slot's `begin_block`/`finish_block` is isolated, so
one tenant's exception retires only that request — transient failures
(`fault.TRANSIENT`) restart from a FRESH cursor after an exponential tick
backoff (a faulted cursor's TopK may hold a partial batch; resuming it
could double-push), any other exception lands on `SpatialRequest.error`
with empty results. A pooled Phase-1/2 call that raises falls back to
per-slot serial Phase 1-2 for that step, and a faulted entry in the shared
Phase-3 batch (`StreamEntry.error`) faults only its rider. Every such event
is counted in `ServeStats`. A kernel never falls back to its plain version:
a failed build or launch raises from `kernels/ops` and the loop records it.
Per-request `QueryDeadline`s pass through to the cursor, so an expired
tenant retires with `stats.partial` anytime results.

The engine runs on CUDA unless it is given ``device="cpu"`` (where the
kernel backends run their plain torch versions), and raises without CUDA.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..core import fault, node_select, shard as shard_mod, spatial_join
from ..core.executor import ExecStats, QueryCursor, StreakEngine
from ..core.join import Relation
from ..core.query import Query


@dataclasses.dataclass
class SpatialRequest:
    rid: int
    query: Query
    scores: np.ndarray | None = None
    rows: Relation | None = None
    stats: ExecStats | None = None
    done: bool = False
    steps: int = 0                  # engine steps this request stayed active
    waited: int = 0                 # engine steps spent queued
    deadline: fault.QueryDeadline | None = None
    error: Exception | None = None  # set ⟹ retired by a permanent failure
    retries: int = 0                # fresh-cursor restarts consumed
    not_before: int = 0             # earliest engine tick re-admission runs


@dataclasses.dataclass
class ServeStats:
    steps: int = 0                  # engine iterations
    admissions: int = 0             # slot claims (== completed requests)
    released_early: int = 0         # slots freed by θ termination mid-scan
    slot_reuse: int = 0             # admissions beyond the first per slot
    sip_batches: int = 0            # pooled candidate_nodes/select calls
    sip_blocks: int = 0             # driver blocks covered by those calls
    join_launches: int = 0          # cross-query fused kernel launches
    max_queue: int = 0
    faults: int = 0                 # slot exceptions caught (any phase)
    retries: int = 0                # transient faults re-queued with backoff
    failed_requests: int = 0        # requests retired with an error
    admission_failures: int = 0     # cursor construction raised in _admit
    pooled_fallbacks: int = 0       # pooled Phase-1/2 → per-slot serial
    share_evictions: int = 0        # FIFO share-cache entry evictions
    deadline_partials: int = 0      # requests retired with partial results


class _FusedJoinBatcher:
    """Collects every slot's Phase-3 streaming join for one engine step and
    runs them as cross-query `fused_stream_join_multi` launches."""

    def __init__(self, batch_cols: int, tuner, device: torch.device):
        self.batch_cols = batch_cols
        self.tuner = tuner
        self.device = device
        self.entries: list[spatial_join.StreamEntry] = []

    def add(self, entry: spatial_join.StreamEntry) -> None:
        self.entries.append(entry)

    @tracing.spanned("phase3.flush", -1)
    def flush(self) -> int:
        if not self.entries:
            return 0
        launches = spatial_join.fused_stream_join_multi(
            self.entries, batch_cols=self.batch_cols, tuner=self.tuner,
            device=self.device)
        self.entries = []
        return launches


class SpatialServeEngine:
    """Slot-based admission loop over a shared `StreakEngine`.

    One engine instance per store: the relation scan cache, the Bloom
    `PreparedKeys`, and the kcap autotuner are shared by every tenant. The
    engine, and so every kernel, runs on `device` (CUDA unless given).
    """

    def __init__(self, store, config=None, max_slots: int = 8,
                 max_retries: int = 2, share_cache_max: int = 1024,
                 device: torch.device | str | None = None):
        self.engine = StreakEngine(store, config, device=device)
        # tenants running the same query shape (a hot query with per-user
        # k, say) share θ-independent per-block work: driver-block
        # materialization, S-Plan filtered retrieval, N-Plan block joins
        # (executor.StreakEngine.share_cache) and pooled Phase-1/2 rows
        # (deduped in step()). Serial per-query execution recomputes all
        # of it per tenant.
        self.engine.share_cache = {}
        self.max_slots = max_slots
        self.max_retries = max_retries
        self.share_cache_max = share_cache_max
        self.slots: list[tuple[SpatialRequest, QueryCursor] | None] = \
            [None] * max_slots
        self.queue: list[SpatialRequest] = []
        self.stats = ServeStats()
        self._slot_used = [False] * max_slots
        self._tick = 0                  # backoff clock: one tick per step()

    # ------------------------------------------------------------------
    def submit(self, req: SpatialRequest) -> None:
        self.queue.append(req)

    def _fail(self, req: SpatialRequest, exc: Exception) -> None:
        """Retire `req` with `exc` surfaced and well-typed empty results —
        never silently dropped, never poisoning other tenants."""
        req.error = exc
        req.scores = np.empty(0)
        req.rows = Relation()
        req.stats = ExecStats()
        req.done = True
        self.stats.failed_requests += 1

    def _fault_slot(self, slot: int, exc: Exception) -> None:
        """One tenant crashed: free its slot, and either re-queue it for a
        fresh-cursor restart (transient failures, bounded exponential tick
        backoff) or retire it with the error surfaced. A faulted cursor is
        always discarded — its TopK may hold a partial emit batch, so only
        a restart from scratch preserves bit-identicality."""
        req, _ = self.slots[slot]
        self.slots[slot] = None
        self.stats.faults += 1
        if isinstance(exc, fault.TRANSIENT) and req.retries < self.max_retries:
            req.retries += 1
            self.stats.retries += 1
            req.not_before = self._tick + (1 << (req.retries - 1))
            self.queue.insert(0, req)   # it was admitted earliest: run next
        else:
            self._fail(req, exc)

    def _admit(self) -> None:
        for slot in range(self.max_slots):
            if self.slots[slot] is not None:
                continue
            i = 0
            while i < len(self.queue):
                req = self.queue[i]
                if req.not_before > self._tick:   # backing off: skip, keep
                    i += 1
                    continue
                self.queue.pop(i)
                try:
                    with tracing.span("serve.admit", req.rid):
                        cur = self.engine.cursor(req.query,
                                                 deadline=req.deadline)
                except Exception as exc:    # noqa: BLE001 — surface per-req
                    self.stats.admission_failures += 1
                    self._fail(req, exc)
                    continue                # next queued request, same slot
                self.slots[slot] = (req, cur)
                self.stats.admissions += 1
                if self._slot_used[slot]:
                    self.stats.slot_reuse += 1
                self._slot_used[slot] = True
                break

    def _retire(self, slot: int) -> None:
        req, cur = self.slots[slot]
        with tracing.span("serve.retire", req.rid):
            req.scores, req.rows, req.stats = cur.results()
            req.done = True
            if cur.stats.early_terminated:
                self.stats.released_early += 1
            if cur.stats.partial:
                self.stats.deadline_partials += 1
            self.slots[slot] = None

    # ------------------------------------------------------------------
    def _slot_sip(self, r: dict) -> list:
        """Per-slot serial Phase-1/2 (the pooled call's degraded mode): the
        same per-shard candidate_nodes + select_batch, one tenant's rows
        only. Returns per-row lists of per-shard V* arrays."""
        shards = shard_mod.shard_views(self.engine.store)
        policy = self.engine.config.policy
        boxes = [b if b is not None else np.zeros((0, 4))
                 for b in r["boxes"]]
        n = len(boxes)
        cs_path = r.get("cs_path")
        sel_shards = []
        for si, sh in enumerate(shards):
            in_v = sh.tree.candidate_nodes(
                boxes, np.full(n, r["dist_norm"]), [r["driven_cs"]] * n,
                prepared=[r["prepared"]] * n,
                probe_backend=policy.probe, descend_backend=policy.descend,
                cs_path=[cs_path[si] if cs_path is not None else None] * n,
                device=self.engine.device)
            sel_shards.append(node_select.select_batch(
                sh.tree, in_v, [r["driven_cs"]] * n,
                self.engine.config.select_params,
                card_all=np.stack([r["card_all"][si]] * n)))
        self.stats.sip_batches += 1
        self.stats.sip_blocks += n
        return [[sel_shards[si][i] for si in range(len(shards))]
                for i in range(n)]

    @tracing.spanned("serve.step", -1)
    def step(self) -> int:
        """One iteration: admit, advance every active slot one driver block
        (Phases 1-2 pooled, Phase 3 cross-query batched), retire finished
        queries. Returns the number of active slots this step.

        Every per-slot phase is crash-isolated: an exception advances only
        that slot to `_fault_slot` (restart or retire) while the rest of the
        step proceeds."""
        self._tick += 1
        self._admit()
        self.stats.max_queue = max(self.stats.max_queue, len(self.queue))
        active = [s for s in range(self.max_slots)
                  if self.slots[s] is not None]
        if not active:
            return 0
        self.stats.steps += 1
        for s in active:
            self.slots[s][0].steps += 1
        for r in self.queue:
            r.waited += 1

        # ---- phase A: materialize one block per slot, pool SIP requests --
        work: list[tuple[int, dict]] = []        # (slot, request)
        for s in active:
            req, cur = self.slots[s]
            try:
                with tracing.span("serve.begin", req.rid):
                    sip_req = cur.begin_block()
            except Exception as exc:    # noqa: BLE001 — isolate the tenant
                self._fault_slot(s, exc)
                continue
            if sip_req is None:                  # finished (θ or exhausted)
                self._retire(s)
                continue
            work.append((s, sip_req))

        sip_slots = [(s, r) for (s, r) in work if r["need_sip"]]
        v_stars: dict[int, list | None] = {s: None for (s, r) in work}
        if sip_slots:
            # one pooled Phase-1/2 call PER SHARD over every tenant's
            # window rows; rows of one tenant share a CS array (and thus
            # one frontier group), different tenants' groups ride the same
            # batch, and identical rows from same-shape tenants collapse
            # to one row — the dedup row set is shard-independent, so the
            # per-shard sweep reuses it as-is
            shards = shard_mod.shard_views(self.engine.store)
            policy = self.engine.config.policy
            boxes, cs_sets, prepared, dists, cards = [], [], [], [], []
            cs_paths = []
            row_of: dict[tuple, int] = {}
            spans: list[tuple[int, list[int]]] = []
            with tracing.span("serve.pool"):
                for s, r in sip_slots:
                    cs_bytes = np.asarray(r["driven_cs"]).tobytes()
                    rows = []
                    for box in r["boxes"]:
                        box = box if box is not None else np.zeros((0, 4))
                        rk = (box.shape, box.tobytes(), cs_bytes,
                              float(r["dist_norm"]))
                        idx = row_of.get(rk)
                        if idx is None:
                            idx = len(boxes)
                            row_of[rk] = idx
                            boxes.append(box)
                            cs_sets.append(r["driven_cs"])
                            prepared.append(r["prepared"])
                            dists.append(r["dist_norm"])
                            cards.append(r["card_all"])
                            # tenants' precomputed root-path masks ride along so
                            # fused descents skip the per-step Bloom probes
                            cs_paths.append(r.get("cs_path"))
                        rows.append(idx)
                    spans.append((s, rows))
            try:
                # cards[i] / cs_paths[i] are per-shard lists (tenant
                # cursors expose one entry per shard view, same order)
                sel_shards = []
                with tracing.span("sip.pooled"):
                    for si, sh in enumerate(shards):
                        in_v = sh.tree.candidate_nodes(
                            boxes, np.array(dists), cs_sets,
                            prepared=prepared,
                            probe_backend=policy.probe,
                            descend_backend=policy.descend,
                            cs_path=[p[si] if p is not None else None
                                     for p in cs_paths],
                            device=self.engine.device)
                        sel_shards.append(node_select.select_batch(
                            sh.tree, in_v, cs_sets,
                            self.engine.config.select_params,
                            card_all=np.stack([c[si] for c in cards])))
                for s, rows in spans:
                    v_stars[s] = [[sel_shards[si][i]
                                   for si in range(len(shards))]
                                  for i in rows]
                self.stats.sip_batches += 1
                self.stats.sip_blocks += len(boxes)
            except Exception:       # noqa: BLE001 — poisoned pooled call
                # one tenant's rows poisoned the shared batch: degrade to
                # per-slot serial Phase-1/2 for this step, so only the
                # culprit faults and the rest keep their V* (bit-identical:
                # candidate_nodes/select_batch are per-row functions)
                self.stats.pooled_fallbacks += 1
                for s, r in sip_slots:
                    try:
                        v_stars[s] = self._slot_sip(r)
                    except Exception as exc:    # noqa: BLE001
                        self._fault_slot(s, exc)

        # ---- phase B: APS + driven retrieval + Phase-3 -------------------
        batcher = None
        if self.engine.config.policy.join == "fused" \
                and self.engine.config.mbr_join_fn is None:
            batcher = _FusedJoinBatcher(self.engine.config.fused_batch_cols,
                                        tuner=self.engine.kcap_tuner,
                                        device=self.engine.device)
        entry_spans: dict[int, slice] = {}       # slot -> its batcher entries
        for s, _ in work:
            if self.slots[s] is None:            # faulted in phase A
                continue
            req, cur = self.slots[s]
            n0 = len(batcher.entries) if batcher is not None else 0
            try:
                with tracing.span("serve.finish", req.rid):
                    cur.finish_block(v_stars[s], batcher=batcher)
            except Exception as exc:    # noqa: BLE001 — isolate the tenant
                if batcher is not None:          # roll back registrations
                    del batcher.entries[n0:]
                self._fault_slot(s, exc)
                continue
            if batcher is not None:
                entry_spans[s] = slice(n0, len(batcher.entries))
        if batcher is not None:
            entries = list(batcher.entries)
            try:
                self.stats.join_launches += batcher.flush()
            except Exception as exc:    # noqa: BLE001 — launch-level crash
                for e in entries:
                    if e.error is None:
                        e.error = exc
            # faulted entries (StreamEntry.error) fault only their riders
            for s, span in entry_spans.items():
                errs = [e.error for e in entries[span] if e.error is not None]
                if errs and self.slots[s] is not None:
                    self._fault_slot(s, errs[0])
        for s, _ in work:
            if self.slots[s] is not None and self.slots[s][1].done:
                self._retire(s)
        # bound the cross-tenant memo (entries hold relations) with
        # insertion-order eviction: dicts iterate oldest-first, so popping
        # from the front drops the stalest per-block results while this
        # step's hot entries survive
        sc = self.engine.share_cache
        if sc is not None:
            while len(sc) > self.share_cache_max:
                sc.pop(next(iter(sc)))
                self.stats.share_evictions += 1
        return len(active)

    def run(self) -> None:
        while self.queue or any(sl is not None for sl in self.slots):
            if self.step() == 0 and not self.queue:
                break

    # ------------------------------------------------------------------
    def serve(self, queries: list[Query]) -> list[SpatialRequest]:
        """Convenience: submit all, run to completion, return requests in
        submission order."""
        reqs = [SpatialRequest(rid=i, query=q) for i, q in enumerate(queries)]
        for r in reqs:
            self.submit(r)
        self.run()
        return reqs
