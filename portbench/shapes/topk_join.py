"""The paper's query shape: a top-k distance join (`datagen.Template`).

    SELECT ?a ?b WHERE { ... } FILTER(distance(?g1, ?g2) <= d)
    ORDER BY ASC(sum w * value(?v)) LIMIT k

A query shape is a file `shapes/<shape>.py` that gives:

- `READS`: the request's fields, beside its template, that the reference's
  answer depends on; `harness.compare` asks for one answer a group of
  requests that agree on them;
- `query(prog, tpl, req)`: the port's `Query`, built through the
  `program.Program`'s `rt` and its term mapping (`prog.patterns`);
- `answer(ref, tpl, reqs)`: the plain reference's answer to a group
  (`reference.Reference` gives the basic graph patterns and the exact
  points, in NumPy);
- `judge(ans, scores, keys, req, tpl)`: (wrong rows, missed rows, edge
  gap) of one answer, decoded to the generator's ids (`Program.decode`);
- `served(ref, tpl, reqs)`: the reference's (scores, keys) to each
  request, as the program would serve them: a control's answers
  (`control.py`);
- optionally `decode(prog, tpl, scores, rows)`, where `Program.keys` does
  not decode the port's answer.
"""
import numpy as np

from portbench import check

READS = ("dist",)


def query(prog, tpl, req):
    rt = prog.rt
    return rt.Query(
        select=prog.select(tpl), patterns=prog.patterns(tpl),
        spatial=rt.SpatialFilter(rt.Var(tpl.geo_a.name),
                                 rt.Var(tpl.geo_b.name), float(req.dist)),
        ranking=rt.Ranking(tuple((rt.Var(v.name), float(w))
                                 for v, w in tpl.ranking),
                           descending=tpl.descending),
        k=int(req.k))


def answer(ref, tpl, reqs):
    """Every row within the distance (and the window beyond it) scoring
    at most T, where T admits the group's largest k."""
    return ref.answer(tpl, reqs[0].dist, max(r.k for r in reqs),
                      check.WINDOW)


def judge(ans, scores, keys, req, tpl):
    return check.judge(scores, keys, ans, req.k, tpl.descending)


def served(ref, tpl, reqs):
    """The rows within the distance, best first, the first k."""
    a = ref.answer(tpl, reqs[0].dist, max(r.k for r in reqs), 0.0)
    order = np.argsort(a.scores, kind="stable")
    return [(a.scores[order[:r.k]].astype(np.float64), a.keys[order[:r.k]])
            for r in reqs]
