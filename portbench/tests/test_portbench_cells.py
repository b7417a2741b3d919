"""Every cell's traffic, at a tiny scale, through `repro_torch` on the CPU:
each answer equal to the plain reference's, and the metric readers fed."""
import json

import numpy as np
import pytest

from portbench import check, datagen, harness, program, reference, traffic

# tiny stores: the configurations' shapes, a few hundred entities a class
SCALES = {"lgd-500k": {"n_per_class": 400},
          "yago3-550k": {"n_places": 1500}}
CELLS = ("lgd.mixed.c8", "yago3.serial.c1", "lgd.hot.c8")
SEED = 2 ** 31 + 12345       # above 32 signed bits, as the driver's are


def tiny(name: str) -> harness.Cell:
    if name == "lgd.hot.c8":
        # the hot mix, kept for a later cell (PERF.md): lgd-500k under
        # traffic/hot.c8
        cell = harness.load_cell("lgd.mixed.c8")
        cell.name = name
        cell.mix = json.loads((harness.ROOT / "portbench" / "traffic" /
                               "hot.c8.json").read_text())
    else:
        cell = harness.load_cell(name)
    cell.config["store"]["block"] = 128
    return cell


def run(name: str, trace: bool = False, seconds: float = 2.0) -> dict:
    cell = tiny(name)
    import time
    return harness.run_cell(cell, SEED, seconds, trace, "cpu",
                            time.perf_counter(), drain_s=60.0,
                            scale=SCALES[cell.config["name"]])


@pytest.mark.parametrize("name", CELLS)
def test_cell_matches_reference(name):
    res = run(name, seconds=12.0)
    assert res["correct"], res["compared"]
    assert res["compared"]["checked_requests"]["value"] > 0
    assert res["attempted"] >= res["compared"]["checked_requests"]["value"]
    assert res["failed"] == 0
    assert set(res["metrics"]) == {"qps", "latency_p50_ms",
                                   "latency_p95_ms", "setup_s"}
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_layers(name):
    res = run(name, trace=True, seconds=6.0)
    assert res["correct"], res["compared"]
    got = res["metrics"]
    # device metrics need the card's trace; the rest are read on the CPU
    assert "device.idle_share" not in got
    for m in ("exec.driver_blocks_per_query", "sip.ms_per_query",
              "driven.ms_per_query", "refine.ms_per_query"):
        assert got[m]["value"] > 0, m
    assert ("serve.steps_per_query" in got) == name.endswith(".c8")
    # the program's own spans and counters, in every traced window
    for m in ("exec.cursor_ms_per_query", "phase3.prepare_ms_per_query"):
        assert got[m]["value"] > 0, m
    assert ("exec.share_hit_share" in got) == name.endswith(".c8")


def test_generator_is_the_programs():
    """The frozen generators draw what repro_torch's own generators draw."""
    rt = program.import_port()
    from repro_torch.data import synth_rdf
    for ours, theirs in ((datagen.make_lgd(300, 3),
                          synth_rdf.make_lgd(300, seed=3)),
                         (datagen.make_yago(900, 4),
                          synth_rdf.make_yago(900, seed=4))):
        names = theirs.store.dictionary.id_to_term
        assert rt is not None
        assert len(ours.terms) == len(theirs.store.dictionary)
        assert ours.quads.nbytes == theirs.raw_nbytes
        # every quad, as terms, is the program's (ids differ after remap)
        mine = {tuple(ours.terms[i - 1] if i else "" for i in q)
                for q in ours.quads.tolist()}
        them = {tuple(names[i] if i else "" for i in q)
                for q in theirs.store.quads.tolist()}
        assert mine == them


def test_relabel_keeps_the_data():
    """Two seeds: one dataset under two sets of identifiers."""
    ds = datagen.make_lgd(200, 0)
    a, b = datagen.relabel(ds, 1), datagen.relabel(ds, 2)

    def as_terms(d):
        return sorted(tuple(d.terms[i - 1] if i else "" for i in q)
                      for q in d.quads.tolist())
    assert as_terms(a) == as_terms(b) == as_terms(ds)
    assert not np.array_equal(a.quads, b.quads)
    ta = {a.terms[e - 1]: g.tolist() for e, g in a.exact.items()}
    assert ta == {ds.terms[e - 1]: g.tolist() for e, g in ds.exact.items()}


def test_traffic_blocks_hold_every_size():
    cell = tiny("lgd.mixed.c8")
    ds = datagen.make_lgd(50, 1)
    seq = traffic.requests(cell.mix, cell.config, ds.templates, SEED)
    first = [next(seq) for _ in range(64)]
    for b in range(0, 64, 8):        # each block: every template once
        assert sorted(r.template for r in first[b:b + 8]) == list(range(8))
    assert sorted((r.template, r.k) for r in first) == sorted(
        (t - 1, k) for t in cell.mix["templates"] for k in cell.mix["k"])
    lo, hi = cell.config["dist_range"]
    for t in range(8):       # each template: one distance in each slice
        slots = sorted(int((r.dist - lo) / (hi - lo) * 8) for r in first
                       if r.template == t)
        assert slots == list(range(8))
    again = traffic.requests(cell.mix, cell.config, ds.templates, SEED)
    assert [next(again) for _ in range(64)] == first


# sha256 of the first 64 requests' (template, distance, k) and of the
# reference's answers to them (scores, keys) at the tiny scales, by mix
# and seed, as the benchmark's first version gave them
FROZEN = {
    ("mixed.c8", 7): (
        "2095d84c74bd2000dcdecd577f2d18e370271c8cf2c65c6632ca5873cd7e938e",
        "03f77dd54fb4a414c02ea2d2170a5827acb34690380d1ef373e5eeeee5213506"),
    ("mixed.c8", 2147495993): (
        "e1bcb7a1be78e7610d0abde2786d6fc69fe4825618af4389fcd820dd994714b8",
        "1c241e9694d0db0f0eea206acd056f1d746d12d90c9b900ff68be47f8be477e8"),
    ("serial.c1", 7): (
        "99c3b1439369cebc9da212fe26a5746509d9698b13b101846cd214d72e6be26a",
        "a08aa5a7d0db92752a8b2af361005775e58a15fe4f392a10ed83d4d90e73b822"),
    ("serial.c1", 2147495993): (
        "ac01b1b602d0d68b963b0e078bb7af2b17cb8f180b4bdc2293f37fa2f128d2ab",
        "53ce31c151a842dc858ae75522a1a122405495ef266d680ab79cdf0d084c8eeb"),
    ("hot.c8", 7): (
        "644e11d4fe271a16663ec46917cad43575eb4fca42b15487ff7c9f7dc354fd7a",
        "873f7b0f20cdee7a87a75627b53975223c5c825fc72440ec1ca6314487e9b627"),
    ("hot.c8", 2147495993): (
        "41acdc8230305ed251493dc3aacbc52298a8c24c8f17e543a7122ca43e9ab6b6",
        "3c316211b35e9e1a79c9a3d134277e2adf3ea180b8cb8e787afcc258737f9748"),
}
MIX_CONFIG = {"mixed.c8": "lgd-500k", "serial.c1": "yago3-550k",
              "hot.c8": "lgd-500k"}


@pytest.mark.parametrize("mix,seed", sorted(FROZEN))
def test_requests_and_answers_are_frozen(mix, seed):
    """Every mix's sequence of templates, distances and k, and the
    reference's answers, stay as they were for every seed: a place drawn
    for other mixes, or a shape's dispatch, moves none of them."""
    import hashlib
    root = harness.ROOT / "portbench"
    cfg = json.loads((root / "configs" / f"{MIX_CONFIG[mix]}.json")
                     .read_text())
    m = json.loads((root / "traffic" / f"{mix}.json").read_text())
    ds = datagen.make(dict(cfg, scale=SCALES[cfg["name"]]), seed)
    seq = traffic.requests(m, cfg, ds.templates, seed)
    reqs = [next(seq) for _ in range(64)]
    assert all(r.pos is None for r in reqs)
    got_reqs = hashlib.sha256(repr([(r.template, float(r.dist).hex(), r.k)
                                    for r in reqs]).encode()).hexdigest()
    shapes = program.shapes_of(ds.templates)
    ref = reference.Reference(ds)
    h = hashlib.sha256()
    for r in reqs:
        tpl = ds.templates[r.template]
        a = shapes[tpl.shape].answer(ref, tpl, [r])
        h.update(a.scores.tobytes())
        h.update(a.keys.tobytes())
    assert (got_reqs, h.hexdigest()) == FROZEN[(mix, seed)]


def test_judge_counts_faults():
    """An altered score, a dropped row and a foreign row each count."""
    ds = datagen.make_lgd(300, 5)
    ref = reference.Reference(ds)
    tpl = ds.templates[0]
    a = ref.answer(tpl, tpl.dist, 20, check.WINDOW)
    inside = np.flatnonzero(a.dist <= a.d)
    order = inside[np.argsort(a.scores[inside], kind="stable")[:20]]
    s, k = a.scores[order], a.keys[order]
    assert check.judge(s, k, a, 20) == (0, 0, 0.0)
    s2 = s.copy()
    s2[3] = np.nextafter(s2[3], np.inf)
    assert check.judge(s2, k, a, 20)[0] > 0
    assert check.judge(s[:19], k[:19], a, 20)[1] > 0
    k2 = k.copy()
    k2[0, 0] = 1
    assert check.judge(s, k2, a, 20)[0] > 0


def test_edge_gap_reads_pairs_decided_against_the_reference():
    """A pair kept just beyond d, or dropped just inside it, is no wrong or
    missed row, but reads its distance from d as the edge gap."""
    ds = datagen.make_lgd(300, 5)
    tpl = ds.templates[0]
    a0 = reference.Reference(ds).answer(tpl, tpl.dist, 20, check.WINDOW)
    d = float(np.sort(a0.dist)[len(a0.dist) // 2])   # a pair at d exactly
    a = reference.Reference(ds).answer(tpl, d * (1 - 1e-3), 10 ** 6,
                                       check.WINDOW)
    at = np.flatnonzero(a.dist == d)[0]
    assert not a.sure[at] and a.dist[at] > a.d
    inside = np.flatnonzero(a.dist <= a.d)
    best = inside[np.argsort(a.scores[inside], kind="stable")]
    # the answer keeps every row inside d and the pair beyond it
    rows = np.sort(np.concatenate([best, [at]]))
    rows = rows[np.argsort(a.scores[rows], kind="stable")]
    w, m, e = check.judge(a.scores[rows], a.keys[rows], a, len(rows))
    assert (w, m) == (0, 0)
    assert e == pytest.approx((d - a.d) / a.d)
    # an answer that drops a row just inside d reads its gap too
    b = reference.Reference(ds).answer(tpl, d * (1 + 1e-3), 10 ** 6,
                                       check.WINDOW)
    inside = np.flatnonzero(b.dist <= b.d)
    keep = inside[b.dist[inside] != d]
    keep = keep[np.argsort(b.scores[keep], kind="stable")]
    w, m, e = check.judge(b.scores[keep], b.keys[keep], b, len(keep) + 1)
    assert (w, m) == (0, 0)
    assert e == pytest.approx((b.d - d) / b.d)


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2 ** -9, 1.0 + 3 * 2 ** -9, 100.3, -2.5e-3],
                 dtype=np.float32)
    got = reference.bf16(x)
    assert got.tolist()[:3] == [1.0, 1.0, 1.0 + 2 ** -7]
    assert abs(got[3] - 100.3) <= 0.25 and got[3] != np.float32(100.3)
    assert (got.view(np.uint32) & 0xFFFF == 0).all()


@pytest.mark.parametrize("name", ("lgd.mixed.c8", "yago3.serial.c1"))
@pytest.mark.parametrize("data_seed", (1, 2))
def test_other_datasets_match_reference(name, data_seed):
    """A configuration fixes its dataset; the comparison holds on others
    its generator draws, too."""
    cell = tiny(name)
    import time
    res = harness.run_cell(cell, SEED + data_seed, 3.0, False, "cpu",
                           time.perf_counter(), drain_s=60.0,
                           scale=SCALES[cell.config["name"]],
                           data_seed=data_seed)
    assert res["correct"], res["compared"]
