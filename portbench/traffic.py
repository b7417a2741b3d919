"""The one traffic generator: a traffic mix's parameters -> requests.

A mix (``traffic/<name>.json``) names the engine and loop, and how each
request draws its template, distance and k:

    {"engine": "serve" | "serial", "clients": 8, "max_slots": 8,
     "templates": [1, ..., 8],       # 1-based template numbers
     "dist": "range" | "template",   # the configuration's range, or the
                                     # template's own distance
     "k": [5, 10, ...],              # the k mix
     "check_sample": 48,             # requests the comparison samples
     "pos": true}                    # optional: each request's place

Requests come in blocks: each block of consecutive requests holds every
template of the mix once, in an order drawn from the seed, so heavy and
light templates stay evenly spread over a window. Over as many blocks as
the mix has k values, each template takes every k once and one distance
from each of as many equal slices of the range, both dealt in orders drawn
from the seed. Every seed so sends the same sizes in another order, and the
work of a window varies little from seed to seed. A template the
configuration lists under `own_k` keeps its own k.

A mix with `"pos": true` gives each request a place in [0, 1)^2, which a
query shape reads to put a window or a centre on the map (``shapes/``),
drawn uniformly from a stream of the seed's own, so the template, distance
and k of every request are those of the same mix without `pos`.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    template: int        # 0-based index into the dataset's templates
    dist: float
    k: int
    pos: tuple | None = None    # (x, y) in [0, 1)^2, where the mix draws it


# the place where no mix draws one: the warm-up's, at the map's centre
CENTRE = (0.5, 0.5)


def places(seed: int):
    """The endless sequence of places for `seed`."""
    rng = np.random.default_rng([int(seed), 0x9D05])
    while True:
        yield from map(tuple, rng.random((1024, 2)).tolist())


def requests(mix: dict, config: dict, templates: list, seed: int):
    """The endless request sequence of `mix` for `seed`."""
    seq = _drawn(mix, config, templates, seed)
    if not mix.get("pos"):
        return seq
    return (dataclasses.replace(r, pos=p)
            for r, p in zip(seq, places(seed)))


def _drawn(mix: dict, config: dict, templates: list, seed: int):
    """Each request's template, distance and k."""
    rng = np.random.default_rng([int(seed), 0x7A11C])
    ks = list(mix["k"])
    lo, hi = config.get("dist_range", (None, None))
    own_k = set(config.get("own_k", ()))
    tpls = np.array(mix["templates"]) - 1
    for _ in itertools.count():
        k_of = {t: rng.permutation(len(ks)) for t in tpls}
        slice_of = {t: rng.permutation(len(ks)) for t in tpls}
        for j in range(len(ks)):
            for t in rng.permutation(tpls):
                tpl = templates[t]
                if mix["dist"] == "template":
                    d = float(tpl.dist)
                else:
                    d = float(lo + (hi - lo) * (slice_of[t][j] + rng.random())
                              / len(ks))
                k = tpl.k if t + 1 in own_k else ks[k_of[t][j]]
                yield Request(int(t), d, int(k))


def warmup(mix: dict, config: dict, templates: list) -> list:
    """One request a template of the mix, at the largest distance and k
    the mix draws (and, where it draws places, at the map's centre): the
    shapes the window will use, before it."""
    out = []
    for t in mix["templates"]:
        tpl = templates[t - 1]
        d = (float(tpl.dist) if mix["dist"] == "template"
             else float(config["dist_range"][1]))
        k = tpl.k if t in set(config.get("own_k", ())) else max(mix["k"])
        out.append(Request(t - 1, d, int(k),
                           CENTRE if mix.get("pos") else None))
    return out
