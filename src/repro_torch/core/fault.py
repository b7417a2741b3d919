"""Query-engine fault tolerance: failover chains, breakers, deadlines.

Every chained op of `kernels/ops` has a plain torch version that gives the
same answer as its CUDA kernel. This module turns that into a degradation
story that never hides a fault:

- ``run_op``: the failover runner behind every chained `kernels/ops` call.
  An op call is a chain of (backend, thunk) attempts: on CUDA the kernel,
  then its plain version on the same card; on the CPU the plain version,
  then the same function again (``oracle``). The chain moves to the next
  attempt only on the fault layer's own failures (`FAILOVER`): an
  `InjectedFault` from an installed `FaultPlan`, an `OpTimeout` from an
  armed `watchdog`, a `CorruptionDetected` from a validator (which runs
  only under a plan). Any other exception (a build that fails, a library
  that does not load, a CUDA launch error, a malformed input) is counted
  and re-raised unchanged. So with no plan installed and no watchdog
  armed, no call runs a plain version in place of its kernel. (The
  reference package's `run_op` fails over on any exception.)
- ``CircuitBreaker``: per (op, backend) failure memory. N consecutive
  failures open the breaker; while a plan is installed or a watchdog armed,
  an open breaker's backend is skipped without being tried; after a
  cooldown one half-open probe is allowed, and a success closes it again.
  `BackendPolicy.resolve` consults the breakers (``demote_stage``), so
  later plans route a stage around a broken op at plan time, again only
  while the fault layer is engaged (`FaultState.blocking` is the one gate).
- ``QueryDeadline``: per-query wall-clock (or driver-block) budget. On
  expiry the cursor stops admitting driver blocks and returns the current
  TopK tagged ``partial=True`` with a certified score bound.
- ``FaultPlan``: deterministic fault injection at the ops seam (fail op X on
  call k, delay it past the watchdog, corrupt-then-detect), with the
  reference's (seed, op, call) hash, so one plan injects at the same
  coordinates in both packages.

The exception classes also name the failures that the multi-tenant serving
loop (`serve/spatial.py`) retries from a fresh cursor (`TRANSIENT`); any
other exception retires the request with its error.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib

import numpy as np
import torch


class InjectedFault(RuntimeError):
    """Raised at the ops seam by a matching FaultPlan rule."""


class CorruptionDetected(RuntimeError):
    """An op result failed its structural validator (corrupt-then-detect)."""


class OpTimeout(RuntimeError):
    """A guarded op launch overran the watchdog deadline."""


class FallbackExhausted(RuntimeError):
    """Every backend of an op's failover chain failed (or was skipped by an
    open breaker). The serving layer treats this as transient and retries
    with backoff."""


# exception types the serving layer retries with backoff; anything else is
# treated as a permanent per-request failure (a real bug, a bad query)
TRANSIENT = (InjectedFault, CorruptionDetected, OpTimeout, FallbackExhausted)
# the failures on which `run_op` moves to the next attempt; every other
# exception propagates from the attempt that raised it
FAILOVER = (InjectedFault, CorruptionDetected, OpTimeout)


# ---------------------------------------------------------------- deadline --
@dataclasses.dataclass
class QueryDeadline:
    """Per-query execution budget: wall-clock seconds, driver blocks, or
    both. The clock starts at construction (for served requests: at
    submission). ``max_blocks`` is the deterministic form tests use."""
    seconds: float | None = None
    max_blocks: int | None = None
    start: float = dataclasses.field(default_factory=time.monotonic)

    def expired(self, blocks: int = 0) -> bool:
        if self.max_blocks is not None and blocks >= self.max_blocks:
            return True
        return (self.seconds is not None
                and time.monotonic() - self.start >= self.seconds)


# ---------------------------------------------------------- circuit breaker --
@dataclasses.dataclass
class CircuitBreaker:
    """Per (op, backend) failure memory: closed -> open -> half-open.

    ``threshold`` consecutive failures open the breaker; while open,
    ``allow()`` is False. After ``cooldown_s`` one half-open probe is
    allowed: a success closes the breaker, a failure reopens it (and
    restarts the cooldown).
    """
    threshold: int = 3
    cooldown_s: float = 30.0
    failures: int = 0
    opened_at: float | None = None
    half_open: bool = False

    @property
    def open(self) -> bool:
        """True until a successful call closes the breaker again."""
        return self.opened_at is not None

    def allow(self) -> bool:
        if self.opened_at is None:
            return True
        if time.monotonic() - self.opened_at < self.cooldown_s:
            return False
        if self.half_open:          # one probe per cooldown window
            return False
        self.half_open = True
        return True

    def ok(self) -> None:
        self.failures = 0
        self.opened_at = None
        self.half_open = False

    def fail(self) -> None:
        self.failures += 1
        if self.half_open or self.failures >= self.threshold:
            self.opened_at = time.monotonic()
            self.half_open = False


# -------------------------------------------------------------- fault plan --
@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One deterministic injection: hit `op` on dispatch call `call`
    (0-based per-op counter; None = every call) with `mode`:

    - ``fail``:    raise InjectedFault before the backend runs
    - ``delay``:   sleep ``delay_s`` inside the guarded launch (pairs with
                   the watchdog to exercise the timeout path)
    - ``corrupt``: poison the backend's result so the op's structural
                   validator rejects it (corrupt-then-detect)

    ``attempts`` is how many chain attempts of the matching call are hit:
    1 (default) fails only the primary backend, and the chain recovers; a
    count >= the chain's length defeats the whole chain, so
    FallbackExhausted surfaces to the serving layer's retry path.
    """
    op: str
    call: int | None = None
    mode: str = "fail"
    delay_s: float = 0.0
    attempts: int = 1


@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault injection, hooked in at the ops seam.

    ``rules`` target specific (op, call) coordinates; ``rate`` adds a
    seeded random primary-attempt failure with probability `rate` per
    dispatch, decided by a stable hash of (seed, op, call index), so the
    draw is independent of op interleaving.
    """
    rules: tuple = ()
    rate: float = 0.0
    seed: int = 0
    ops: tuple | None = None          # restrict `rate` to these ops
    calls: dict = dataclasses.field(default_factory=dict)   # op -> count
    injected: int = 0

    def begin_call(self, op: str) -> int:
        idx = self.calls.get(op, 0)
        self.calls[op] = idx + 1
        return idx

    def _rate_hit(self, op: str, call: int) -> bool:
        if self.rate <= 0.0 or (self.ops is not None and op not in self.ops):
            return False
        h = zlib.crc32(f"{self.seed}:{op}:{call}".encode())
        return (h / 0xFFFFFFFF) < self.rate

    def action(self, op: str, call: int, attempt: int) -> tuple | None:
        """Injection for attempt `attempt` of dispatch call `call` of `op`:
        None, ("fail",), ("delay", s) or ("corrupt",)."""
        for r in self.rules:
            if r.op == op and (r.call is None or r.call == call) \
                    and attempt < r.attempts:
                self.injected += 1
                return (r.mode, r.delay_s) if r.mode == "delay" else (r.mode,)
        if attempt == 0 and self._rate_hit(op, call):
            self.injected += 1
            return ("fail",)
        return None


# ------------------------------------------------------------ global state --
@dataclasses.dataclass
class FaultStats:
    failures: int = 0             # backend attempts that raised
    timeouts: int = 0             # ... of which watchdog overruns
    corruptions_detected: int = 0  # validator rejections
    fallbacks: int = 0            # successful non-primary attempts
    exhausted: int = 0            # chains with no surviving backend
    breaker_opens: int = 0
    policy_demotions: int = 0     # plan-time reroutes around open breakers


class FaultState:
    """Process-global failover state: the installed FaultPlan, the
    per-(op, backend) breakers, the watchdog deadline, and the attempts a
    watchdog abandoned (`abandoned`, their threads). Single-writer: the
    query path is single-threaded, and a watchdog's worker runs one
    attempt's thunk, which touches this state only through a nested chain.
    """

    def __init__(self):
        self.plan: FaultPlan | None = None
        self.watchdog_s: float | None = None
        self.breakers: dict[tuple, CircuitBreaker] = {}
        self.breaker_threshold = 3
        self.breaker_cooldown_s = 30.0
        self.stats = FaultStats()
        self.abandoned: list[threading.Thread] = []

    def breaker(self, op: str, backend: str) -> CircuitBreaker:
        key = (op, backend)
        br = self.breakers.get(key)
        if br is None:
            br = self.breakers[key] = CircuitBreaker(
                threshold=self.breaker_threshold,
                cooldown_s=self.breaker_cooldown_s)
        return br

    def engaged(self) -> bool:
        """A plan installed or a watchdog armed: the only times a chain may
        move past its primary attempt."""
        return self.plan is not None or self.watchdog_s is not None

    def blocking(self, op: str, backend: str) -> CircuitBreaker | None:
        """The open breaker of (op, backend) while the fault layer is
        engaged, else None: the one gate behind both the chain's skip
        (`run_op`) and the plan-time reroute (`demote_stage`). Failures of
        any kind feed the breakers, but with no plan installed and no
        watchdog armed none of them moves work off a kernel."""
        if not self.breakers or not self.engaged():
            return None
        br = self.breakers.get((op, backend))
        return br if br is not None and br.open else None

    def join_abandoned(self, timeout: float | None = None) -> bool:
        """Wait for every attempt a watchdog abandoned to end (each runs on
        to its end in the background); True when none is left."""
        for t in self.abandoned:
            t.join(timeout)
        self.abandoned = [t for t in self.abandoned if t.is_alive()]
        return not self.abandoned

    def reset(self) -> None:
        self.plan = None
        self.watchdog_s = None
        self.breakers.clear()
        self.stats = FaultStats()


STATE = FaultState()


def install_plan(plan: FaultPlan | None) -> None:
    STATE.plan = plan


@contextlib.contextmanager
def fault_plan(plan: FaultPlan):
    """Install `plan` for the duration of the block (tests)."""
    prev = STATE.plan
    STATE.plan = plan
    try:
        yield plan
    finally:
        STATE.plan = prev


@contextlib.contextmanager
def watchdog(seconds: float | None):
    """Arm the per-launch watchdog for the duration of the block. With no
    watchdog armed (the default) launches run inline at zero overhead."""
    prev = STATE.watchdog_s
    STATE.watchdog_s = seconds
    try:
        yield
    finally:
        STATE.watchdog_s = prev


# ------------------------------------------------------------ failover run --
def _guarded(thunk, watchdog_s: float | None, op: str, backend: str):
    """Run `thunk` under the watchdog. A launch that overruns raises
    OpTimeout and is abandoned: the worker is a daemon thread that runs on
    to its end into the void (its result is discarded, the fallback's is
    used; `STATE.abandoned` keeps its thread).

    PyTorch's current CUDA stream is per thread, so the worker launches on
    the caller's stream, captured here. An abandoned attempt shares no
    buffer with the one that replaces it: every op allocates its outputs a
    call, and the pinned staging of `kernels/ops` is held under a lock for
    a whole call, so a later call waits for an abandoned one to finish."""
    if watchdog_s is None:
        return thunk()
    box: dict = {}
    stream = (torch.cuda.current_stream()
              if torch.cuda.is_available() and torch.cuda.is_initialized()
              else None)

    def work():
        try:
            if stream is None:
                box["out"] = thunk()
            else:
                with torch.cuda.stream(stream):
                    box["out"] = thunk()
        except Exception as e:      # noqa: BLE001 — relayed below
            box["err"] = e

    t = threading.Thread(target=work, daemon=True,
                         name=f"op-watchdog-{op}-{backend}")
    t.start()
    t.join(watchdog_s)
    if t.is_alive():
        STATE.abandoned.append(t)
        raise OpTimeout(f"{op}/{backend} exceeded {watchdog_s}s watchdog")
    if "err" in box:
        raise box["err"]
    return box["out"]


def _poison(a):
    """A copy of one array or tensor with element 0 out of its domain: NaN
    for floats, the minimum for ints, 2 for bools (through a uint8 view, as
    a bool has no out-of-domain value)."""
    if isinstance(a, torch.Tensor):
        a = a.clone(memory_format=torch.contiguous_format)
        flat = (a.view(torch.uint8) if a.dtype == torch.bool else a).view(-1)
        if flat.numel():
            flat[0] = (2 if a.dtype == torch.bool else float("nan")
                       if a.is_floating_point() else torch.iinfo(a.dtype).min)
        return a
    a = np.array(np.asarray(a))
    flat = (a.view(np.uint8) if a.dtype == bool else a).reshape(-1)
    if len(flat):
        flat[0] = (2 if a.dtype == bool else np.nan
                   if np.issubdtype(a.dtype, np.floating)
                   else np.iinfo(a.dtype).min)
    return a


def _corrupt(out):
    """Poison a result so a structural validator can detect it: the first
    array of the result gets an out-of-domain element 0. Only FaultPlan
    `corrupt` rules call this."""
    if isinstance(out, tuple):
        return (_poison(out[0]),) + out[1:]
    return _poison(out)


def run_op(op: str, attempts: list, validate=None):
    """Run an op through its failover chain.

    `attempts` is the ordered chain [(backend_name, thunk), ...], every
    backend giving the same answer. Each attempt runs under the watchdog
    (when armed) and the installed FaultPlan's injections. On a `FAILOVER`
    failure (injected, timed out, or rejected by `validate`) the
    per-(op, backend) breaker records it and the next backend runs; any
    other exception is recorded the same way and re-raised. `validate` is
    the op's cheap structural check (the corrupt-then-detect hook); it runs
    only under an installed plan, so the fault-free path never pays for it.
    An open breaker skips its backend only while the fault layer is
    engaged (`FaultState.blocking`).

    Raises FallbackExhausted when no backend survives.
    """
    st = STATE
    plan = st.plan
    call_idx = plan.begin_call(op) if plan is not None else 0
    last_err = None
    for ai, (backend, thunk) in enumerate(attempts):
        br = st.blocking(op, backend)
        if br is not None and not br.allow():
            continue
        try:
            act = plan.action(op, call_idx, ai) if plan is not None else None
            if act is not None and act[0] == "fail":
                raise InjectedFault(
                    f"injected failure: {op}[{call_idx}]/{backend}")
            if act is not None and act[0] == "delay":
                delay = act[1]

                def run(thunk=thunk, delay=delay):
                    time.sleep(delay)
                    return thunk()
            else:
                run = thunk
            out = _guarded(run, st.watchdog_s, op, backend)
            if act is not None and act[0] == "corrupt":
                out = _corrupt(out)
            if validate is not None and plan is not None \
                    and not validate(out):
                st.stats.corruptions_detected += 1
                raise CorruptionDetected(
                    f"{op}/{backend} result failed validation")
            br = st.breakers.get((op, backend)) if st.breakers else None
            if br is not None:
                br.ok()
            if ai:
                st.stats.fallbacks += 1
            return out
        except Exception as e:
            br = st.breaker(op, backend)
            was_open = br.open
            br.fail()
            if not was_open and br.open:
                st.stats.breaker_opens += 1
            st.stats.failures += 1
            if isinstance(e, OpTimeout):
                st.stats.timeouts += 1
            if not isinstance(e, FAILOVER):
                raise
            last_err = e
    st.stats.exhausted += 1
    raise FallbackExhausted(f"every backend failed for {op}") from last_err


# ------------------------------------------------------- policy demotion ----
# Backends whose open breaker marks an op degraded: the CUDA kernel, and the
# plain version (the primary attempt on the CPU, the kernel's fallback on
# CUDA). Breakers on the last-resort `oracle`/`numpy` attempts and on the
# sharded descent's `sequential` loop never demote.
_FRAGILE = {"kernel", "plain"}

# stage -> {policy backend: (op whose breaker gates it, safe fallback)}, over
# the port's registries: spatial_join.JOIN_BACKENDS, ops.RANK_BACKENDS,
# charsets.PROBE_BACKENDS, squadtree.DESCEND_BACKENDS
_STAGE_DEMOTIONS = {
    "join": {"fused": ("fused_topk_join", "numpy"),
             "kernel": ("distance_join_matrix", "numpy")},
    "rank": {"kernel": ("merge_join_ranks", "numpy")},
    "probe": {"kernel": ("bloom_probe", "numpy")},
    "descend": {"kernel": ("tree_descend", "numpy")},
}


def op_degraded(op: str) -> bool:
    """Is any non-oracle backend of `op` breaker-open while the fault layer
    is engaged?"""
    return any(STATE.blocking(op, b) is not None for b in _FRAGILE)


def demote_stage(stage: str, backend: str) -> str:
    """Plan-time reroute: while a plan is installed or a watchdog armed, if
    the op behind a stage's resolved backend is breaker-open, resolve to
    the safe fallback instead, so later plans skip the broken backend
    entirely. Called from `BackendPolicy.resolve`; with the fault layer
    idle or a clean breaker registry it is a no-op. (The reference demotes
    on an open breaker whether or not a plan is installed.)"""
    ent = _STAGE_DEMOTIONS.get(stage, {}).get(backend)
    if ent is not None and op_degraded(ent[0]):
        STATE.stats.policy_demotions += 1
        return ent[1]
    return backend
