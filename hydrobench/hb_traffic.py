"""The one traffic generator: a mix is a file of parameters
(``traffic/<name>.json``) that this module reads.

A query scans a slice of fresh rows of the review table (row ids are
never reused). Query sizes come from a deck of ``deck`` sizes, the
quantiles (i + 1/2) / deck of the size distribution, dealt in an order
drawn from the seed in which every few queries hold one size of each
stratum of the distribution: every seed serves the same sizes at the
same mix, so seeds change which rows and in what order, not how much
work. The k-th query's rows
(ratings, lengths, tokens) are drawn from the seed and k alone, so the
reference can draw them again.

Parameters:

- ``clients``: closed-loop clients, each submitting its next query when
  its last one returns.
- ``rows_per_query``: {"median", "sigma", "min", "max", "deck",
  "strata"}, a lognormal clipped to [min, max]; ``deck`` sizes dealt so
  that each run of ``strata`` queries holds one of each stratum.
- ``rating``: {"values", "counts"}: a row's rating is drawn with odds
  proportional to ``counts`` (a corpus's published counts a star).
- ``tokens``: a row's live tokens, {"dist": "uniform", "min", "max"} or
  {"dist": "lognormal", "mu", "sigma", "min", "max", "truncate"}: the
  floor of a lognormal, clipped to [min, max] (lengths beyond them
  counted at the ends), or with ``truncate`` true drawn from the
  lognormal's mass inside [min, max] alone.
- ``words``: {"food": [lo, hi), "service": [lo, hi), "generic": [lo, hi),
  "generic_share"}: each row has a topic, food or service with equal odds;
  each token is a word of its topic, or with odds ``generic_share`` a
  generic word.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


class Row:
    """One review as the program's scan reads it."""

    __slots__ = ("rid", "tokens", "rating")

    def __init__(self, rid: int, tokens: np.ndarray, rating: int):
        self.rid, self.tokens, self.rating = rid, tokens, rating


def _size_deck(spec: dict) -> list:
    nd = NormalDist()
    out = []
    for i in range(spec["deck"]):
        z = nd.inv_cdf((i + 0.5) / spec["deck"])
        v = spec["median"] * math.exp(spec["sigma"] * z)
        out.append(int(min(max(round(v), spec["min"]), spec["max"])))
    return out


def length_odds(spec: dict) -> tuple:
    """The lengths min..max and the odds of each under a lognormal(mu,
    sigma) whose floor is the length, truncated to [min, max]."""
    nd = NormalDist(spec["mu"], spec["sigma"])
    values = np.arange(spec["min"], spec["max"] + 1)
    cdf = np.array([nd.cdf(math.log(v)) for v in
                    range(spec["min"], spec["max"] + 2)])
    odds = np.diff(cdf)
    return values, odds / odds.sum()


def _deal(deck: list, strata: int, rng: np.random.Generator) -> list:
    """The deck in an order drawn from ``rng`` in which every run of
    ``strata`` consecutive queries holds one size of each stratum (the
    sorted deck cut into ``strata`` equal parts): a window that serves a
    few such runs serves the whole distribution, whatever the seed."""
    per = len(deck) // strata
    parts = [list(rng.permutation(sorted(deck)[i * per:(i + 1) * per]))
             for i in range(strata)]
    out = []
    for j in range(per):
        out += [int(parts[i][j]) for i in rng.permutation(strata)]
    return out


class Traffic:
    """The queries of one mix under one seed."""

    def __init__(self, params: dict, seed: int):
        self.params = params
        self.seed = int(seed)
        self.clients = int(params["clients"])
        self.deck = _deal(_size_deck(params["rows_per_query"]),
                          params["rows_per_query"]["strata"],
                          np.random.default_rng([self.seed, 0]))

    def size(self, k: int) -> int:
        return self.deck[k % len(self.deck)]

    def first_row(self, k: int) -> int:
        """The row id of query k's first row: the rows of queries 0..k-1
        come before it."""
        whole, rest = divmod(k, len(self.deck))
        return whole * sum(self.deck) + sum(self.deck[:rest])

    def lengths(self, rng: np.random.Generator, n: int) -> np.ndarray:
        spec = self.params["tokens"]
        if spec["dist"] == "uniform":
            v = rng.integers(spec["min"], spec["max"] + 1, size=n)
        elif spec["dist"] == "lognormal" and spec.get("truncate"):
            values, odds = length_odds(spec)
            v = rng.choice(values, size=n, p=odds)
        elif spec["dist"] == "lognormal":
            v = rng.lognormal(spec["mu"], spec["sigma"], size=n).astype(int)
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        return np.clip(v, spec["min"], spec["max"]).astype(np.int64)

    def rows(self, k: int, *, stream: int = 1) -> list:
        """Query k's rows (``stream`` 2 draws the warm-up's, with ids past
        any the window could use)."""
        n = self.size(k)
        rng = np.random.default_rng([self.seed, stream, k])
        w = self.params["words"]
        r = self.params["rating"]
        odds = np.asarray(r["counts"], np.float64)
        ratings = rng.choice(np.asarray(r["values"]), size=n,
                             p=odds / odds.sum())
        lengths = self.lengths(rng, n)
        width = int(lengths.max())
        food = rng.random(n) < 0.5
        lo = np.where(food, w["food"][0], w["service"][0])[:, None]
        hi = np.where(food, w["food"][1], w["service"][1])[:, None]
        topic = lo + (rng.random((n, width)) * (hi - lo)).astype(np.int64)
        generic = rng.integers(w["generic"][0], w["generic"][1],
                               size=(n, width))
        toks = np.where(rng.random((n, width)) < w["generic_share"], generic,
                        topic).astype(np.int32)
        base = self.first_row(k) if stream == 1 else (1 << 40) + k * 8192
        return [Row(base + i, toks[i, :lengths[i]], int(ratings[i]))
                for i in range(n)]
