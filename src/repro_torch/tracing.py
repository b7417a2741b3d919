"""Spans and counters inside the program: where a query's host time goes.

A span marks one region of STREAK's query path. Its name is
``<layer>.<part>`` (``serve.step``, ``exec.materialize``, ``sip.descend``,
``phase3.flush``, ``refine.exact``, ...), the layer being one of the
program's layers from the serve loop down to refinement::

    with tracing.span("exec.filter_material"):
        intervals, explicit = shard.filter_material(v_star)

Off, the default, `span` returns one shared object that does nothing: it
allocates nothing and reads no clock, and the cost is one check of a
global. On (`enable()`), a span records its name, its start and end on
`time.perf_counter_ns()`'s clock, the index of the span open around it
(its parent: the span that caused it) and a request id. The id is the one
given to `span`; a span given none takes its parent's, and a span with no
parent its own index (a serial `exec.execute` is its request's root). The
serve loop gives each request's spans the request's `rid`, and its pooled
spans -1. While the recorder is on, every garbage collection is recorded
as a `host.gc` span with its generation. Spans live in flat integer
columns, not in Python objects, so the recorder does not feed the
collector that it times.

`drain()` is the one way out: it hands over the spans recorded so far and
empties the recorder. Its columns are the operator's per-request view:
the spans of one request are those with its id, and `self_ns` gives each
span's time less its children's. The recorder serves one thread.

`COUNTS` holds counters that are always on, incremented where the work
happens as `kernels/ops.LAUNCHES` is: ``share.hit:<kind>`` and
``share.miss:<kind>`` at each lookup of `StreakEngine.share_cache`,
``h2d.copy:<op>`` for the bytes copied from host to device and
``h2d.mapped:<op>`` for the bytes a kernel reads in place from pinned host
memory.
"""
from __future__ import annotations

import functools
import gc
import time
from array import array

import numpy as np

COUNTS: dict[str, int] = {}

# the recorder: one row a span, over six columns of int64
_COLUMNS = ("name", "start", "end", "parent", "rid", "gen")
_cols = {c: array("q") for c in _COLUMNS}
_name, _start, _end, _parent, _rid, _gen = (_cols[c] for c in _COLUMNS)
_names: list[str] = []          # interned span names, by id
_ids: dict[str, int] = {}
_stack: list[int] = []          # rows of the spans open now, outermost first
_gc_start = array("q", [0])
_on = False


def count(key: str, n: int = 1) -> None:
    """Add `n` to the always-on counter `key` of `COUNTS`."""
    COUNTS[key] = COUNTS.get(key, 0) + n


def _row(name: str, rid: int | None, gen: int) -> int:
    i = len(_name)
    nid = _ids.get(name)
    if nid is None:
        nid = _ids[name] = len(_names)
        _names.append(name)
    parent = _stack[-1] if _stack else -1
    if rid is None:
        rid = _rid[parent] if parent >= 0 else i
    _name.append(nid)
    _parent.append(parent)
    _rid.append(rid)
    _gen.append(gen)
    return i


class _Off:
    """What `span` returns while the recorder is off."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


class _Close:
    """What `span` returns while the recorder is on: it closes the
    innermost open span."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        t = time.perf_counter_ns()
        if _stack:
            _end[_stack.pop()] = t
        return False


_OFF, _CLOSE = _Off(), _Close()


def span(name: str, rid: int | None = None):
    """A context manager around one region named `name`, on behalf of
    request `rid` (None: the parent's). Use it only in a `with`
    statement: while the recorder is on, the span opens when `span` is
    called."""
    if not _on:
        return _OFF
    _row(name, rid, -1)
    _end.append(-1)
    _start.append(time.perf_counter_ns())
    _stack.append(len(_start) - 1)
    return _CLOSE


def spanned(name: str, rid: int | None = None):
    """Decorator: each call of the function is one span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with span(name, rid):
                return fn(*args, **kwargs)
        return run
    return wrap


def current_rid() -> int:
    """The request id of the innermost open span; -1 when none is open or
    the recorder is off."""
    return _rid[_stack[-1]] if _stack else -1


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _gc_start[0] = time.perf_counter_ns()
        return
    t = time.perf_counter_ns()
    _row("host.gc", -1 if not _stack else None, info["generation"])
    _start.append(_gc_start[0])
    _end.append(t)


def enable() -> None:
    """Record spans, and time garbage collections, from now on."""
    global _on
    if not _on:
        _on = True
        gc.callbacks.append(_on_gc)


def disable() -> None:
    """Stop recording; spans still open end now."""
    global _on
    if _on:
        _on = False
        gc.callbacks.remove(_on_gc)
    t = time.perf_counter_ns()
    while _stack:
        _end[_stack.pop()] = t


def drain() -> tuple[dict, list]:
    """(spans, names): every span recorded since the last drain, as int64
    arrays by column ("name": an index into `names`, "start" and "end" in
    perf_counter nanoseconds, "parent": the row of the enclosing span or
    -1, "rid", "gen": a collection's generation or -1), and empties the
    recorder. Call it outside any span: a span open now is returned with
    end -1 and closes nothing later."""
    spans = {c: np.frombuffer(_cols[c], dtype=np.int64).copy()
             if len(_cols[c]) else np.empty(0, np.int64) for c in _COLUMNS}
    for col in _cols.values():
        del col[:]
    _stack.clear()
    return spans, list(_names)


def self_ns(spans: dict) -> np.ndarray:
    """Each span's nanoseconds less those of its direct children."""
    dur = spans["end"] - spans["start"]
    out = dur.copy()
    kids = spans["parent"] >= 0
    np.subtract.at(out, spans["parent"][kids], dur[kids])
    return out
