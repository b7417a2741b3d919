"""`correct` comes out false when the timed path is broken underneath, and
for the controls (the reference one precision down in the program's
place: float32 scores, or bfloat16 distances). The
chip check is skipped: the runs drive the port on the CPU at a tiny scale.

The faults of a one-chip cell: a step that leaves the state unchanged, half
of a batch left out, and an answer altered where it is produced. No cell
spans chips, so none leaves an exchange between chips out."""
import numpy as np
import pytest

from portbench import control, harness, program

from test_portbench_cells import SCALES, SEED, run, tiny


def _stale_serve_step(monkeypatch):
    from repro_torch.serve.spatial import SpatialServeEngine

    def step(self):               # the state as it was: nothing advances
        return sum(s is not None for s in self.slots)
    monkeypatch.setattr(SpatialServeEngine, "step", step)


def _stale_cursor_step(monkeypatch):
    from repro_torch.core.executor import QueryCursor

    def step(self):               # a block passes, the top-k unchanged
        self.b += 1
        if self.b >= self.n_blocks:
            self._finish()
    monkeypatch.setattr(QueryCursor, "step", step)


def _half_batch(monkeypatch):
    from repro_torch.core.executor import StreakEngine
    emit = StreakEngine._emit_pairs

    def half(self, pi, pj, *args, **kwargs):
        h = len(pi) // 2
        return emit(self, pi[:h], pj[:h], *args, **kwargs)
    monkeypatch.setattr(StreakEngine, "_emit_pairs", half)


def _altered_answer(monkeypatch):
    from repro_torch.core.executor import QueryCursor
    results = QueryCursor.results

    def altered(self):
        scores, rows, stats = results(self)
        if len(scores):
            scores = scores.copy()
            scores[0] = np.nextafter(scores[0], np.inf)
        return scores, rows, stats
    monkeypatch.setattr(QueryCursor, "results", altered)


FAULTS = {
    ("lgd.mixed.c8", "stale step"): _stale_serve_step,
    ("yago3.serial.c1", "stale step"): _stale_cursor_step,
    ("lgd.mixed.c8", "half batch"): _half_batch,
    ("yago3.serial.c1", "half batch"): _half_batch,
    ("lgd.hot.c8", "stale step"): _stale_serve_step,
    ("lgd.hot.c8", "half batch"): _half_batch,
    ("lgd.mixed.c8", "altered answer"): _altered_answer,
    ("yago3.serial.c1", "altered answer"): _altered_answer,
    ("lgd.hot.c8", "altered answer"): _altered_answer,
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    """The fault is planted once the warm-up is done: in the window."""
    program.import_port()
    warm = harness._warm

    def warm_then_break(*args, **kwargs):
        warm(*args, **kwargs)
        FAULTS[(cell, fault)](monkeypatch)
    monkeypatch.setattr(harness, "_warm", warm_then_break)
    res = run(cell, seconds=1.0)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", ("lgd.mixed.c8", "yago3.serial.c1",
                                  "lgd.hot.c8"))
def test_control_is_not_correct(name):
    cell = tiny(name)
    got = control.readings(cell, SEED, 24, scale=SCALES[cell.config["name"]])
    assert not harness.is_correct(got), got
    assert got["wrong_rows"]["value"] > 0


@pytest.mark.parametrize("name", ("lgd.mixed.c8", "yago3.serial.c1",
                                  "lgd.hot.c8"))
def test_bf16_distance_control_is_not_correct(name):
    """Float64 scores over bfloat16 distances: the edge gap reads far
    above its limit, or rows go wrong or missing."""
    cell = tiny(name)
    got = control.readings(cell, SEED, 48, scale=SCALES[cell.config["name"]],
                           kind="dist")
    assert not harness.is_correct(got), got
    assert got["edge_gap"]["value"] > got["edge_gap"]["limit"] or \
        got["wrong_rows"]["value"] + got["missed_rows"]["value"] > 0
