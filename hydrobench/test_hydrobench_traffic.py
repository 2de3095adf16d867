"""The traffic generator: the same seed gives the same queries, every seed
the same sizes, and the rows follow the mix's parameters."""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from hb_traffic import Traffic, length_odds  # noqa: E402

MIXES = {p.stem: json.loads(p.read_text())
         for p in sorted((HERE / "traffic").glob("*.json"))}
SEED = 2**31 + 12345   # past 32 signed bits, as a run's seed may be


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_same_seed_same_queries(mix):
    a, b = Traffic(MIXES[mix], SEED), Traffic(MIXES[mix], SEED)
    for k in (0, 5, 70):
        ra, rb = a.rows(k), b.rows(k)
        assert [r.rid for r in ra] == [r.rid for r in rb]
        assert all(np.array_equal(x.tokens, y.tokens) and x.rating == y.rating
                   for x, y in zip(ra, rb))
    other = Traffic(MIXES[mix], SEED + 1).rows(0)
    assert not all(np.array_equal(x.tokens, y.tokens)
                   for x, y in zip(a.rows(0), other))


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_every_seed_same_sizes(mix):
    spec = MIXES[mix]["rows_per_query"]
    decks = [sorted(Traffic(MIXES[mix], s).deck) for s in (1, 2, SEED)]
    assert decks[0] == decks[1] == decks[2]
    deck = decks[0]
    assert len(deck) == spec["deck"]
    assert spec["min"] <= min(deck) and max(deck) <= spec["max"]
    assert deck[len(deck) // 2 - 1] <= spec["median"] <= deck[len(deck) // 2]
    # the clipped lognormal's mean, e^(sigma^2/2) times the median
    want = spec["median"] * math.exp(spec["sigma"] ** 2 / 2)
    assert abs(np.mean(deck) / want - 1) < 0.05
    # every run of `strata` queries holds one size of each stratum
    per = spec["deck"] // spec["strata"]
    stratum = {v: i // per for i, v in enumerate(deck)}
    dealt = Traffic(MIXES[mix], SEED).deck
    for j in range(0, len(dealt), spec["strata"]):
        assert sorted(stratum[v] for v in dealt[j:j + spec["strata"]]) == \
            list(range(spec["strata"]))


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_rows_follow_parameters(mix):
    p = MIXES[mix]
    t = Traffic(p, SEED)
    rows = [r for k in range(8) for r in t.rows(k)]
    ids = [r.rid for r in rows]
    assert ids == list(range(t.first_row(0), t.first_row(8)))
    lengths = np.array([len(r.tokens) for r in rows])
    tok = p["tokens"]
    assert lengths.min() >= tok["min"] and lengths.max() <= tok["max"]
    if tok["dist"] == "uniform":
        assert abs(lengths.mean() - (tok["min"] + tok["max"]) / 2) < 3
    elif tok.get("truncate"):   # the lognormal's mean over [min, max]
        values, odds = length_odds(tok)
        assert abs(lengths.mean() - values @ odds) < 3
        assert abs(values @ odds - 438) < 2   # mu 4.31, sigma 0.9, 384-512
    else:   # clipped lognormal: about its mean, e^(mu + sigma^2 / 2)
        want = math.exp(tok["mu"] + tok["sigma"] ** 2 / 2)
        assert 0.85 < lengths.mean() / want < 1.15
    ratings = np.array([r.rating for r in rows])
    assert set(ratings) == set(p["rating"]["values"])
    counts = np.asarray(p["rating"]["counts"], np.float64)
    for v, share in zip(p["rating"]["values"], counts / counts.sum()):
        assert abs((ratings == v).mean() - share) < 0.015, v
    words = p["words"]
    allt = np.concatenate([r.tokens for r in rows])
    assert allt.min() >= words["food"][0] and allt.max() < words["generic"][1]
    generic = (allt >= words["generic"][0]).mean()
    assert abs(generic - words["generic_share"]) < 0.02
    # warm-up rows never share an id with the window's
    warm = t.rows(0, stream=2)
    assert min(r.rid for r in warm) > t.first_row(10**6)


def test_truncated_lengths_have_no_mass_piled_at_the_ends():
    """Truncation draws from the law's mass inside [min, max]; clipping
    would pile everything beyond them onto the ends."""
    tok = MIXES["long"]["tokens"]
    assert tok.get("truncate")
    values, odds = length_odds(tok)
    assert abs(odds.sum() - 1) < 1e-12 and (odds > 0).all()
    assert odds[-1] < odds[0] < 0.02        # the density falls over 384-512
    t = Traffic(MIXES["long"], SEED)
    lengths = np.concatenate([[len(r.tokens) for r in t.rows(k)]
                              for k in range(8)])
    for end, share in ((tok["min"], odds[0]), (tok["max"], odds[-1])):
        assert abs((lengths == end).mean() - share) < 0.01
