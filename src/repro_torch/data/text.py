"""Synthetic review corpus for UC4 (LLM predicate over food reviews).

Port of ``repro.data.text`` (numpy only): the same seed gives the same
reviews, token for token, as the JAX package's.

Reviews have heavy-tailed length distribution (the workload-imbalance driver
in the paper's Fig 13/14) and planted topic ("food" | "service") + rating
ground truth.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

FOOD_WORDS = list(range(10, 60))
SERVICE_WORDS = list(range(60, 110))


@dataclass
class Review:
    rid: int
    tokens: np.ndarray   # int32
    rating: int          # 1..5
    topic: str           # "food" | "service"


def make_reviews(n: int = 600, *, seed: int = 0, vocab: int = 256) -> List[Review]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        topic = "food" if rng.random() < 0.5 else "service"
        # heavy-tailed lengths: many short, few very long
        length = int(np.clip(rng.lognormal(3.0, 0.9), 8, 512))
        pool = FOOD_WORDS if topic == "food" else SERVICE_WORDS
        toks = rng.choice(pool, size=length).astype(np.int32)
        # sprinkle generic words
        generic = rng.integers(110, vocab, size=length).astype(np.int32)
        mask = rng.random(length) < 0.3
        toks = np.where(mask, generic, toks)
        rating = int(rng.integers(1, 6))
        out.append(Review(i, toks, rating, topic))
    return out


def topic_of_tokens(tokens: np.ndarray) -> str:
    """Ground-truth oracle used to verify the LLM predicate."""
    food = int(np.isin(tokens, FOOD_WORDS).sum())
    service = int(np.isin(tokens, SERVICE_WORDS).sum())
    return "food" if food >= service else "service"
