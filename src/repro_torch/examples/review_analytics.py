"""UC4: negative-food-review analytics with a REAL transformer LLM predicate.

SELECT * FROM foodreview
WHERE LLM('food or service?', review) = 'food' AND rating <= 1;

Port of the JAX package's examples/review_analytics.py. The LLM is a
reduced decoder from the model zoo. --train-probe first fine-tunes it for
a few steps on labeled synthetic reviews with ``make_train_step`` (on the
card: the flash kernel and its hand-written gradient), so the predicate
is actually accurate, not just expensive; then the query runs through
the full Hydro pipeline with the rating predicate pushed down and
data-aware Laminar balancing over the heavy-tailed review lengths. The
predicate holds the arbiter label "cuda:0" (the JAX package's "tpu:0").

  PYTHONPATH=src python -m repro_torch.examples.review_analytics --reviews 200 --train-probe 30

--device cpu runs the plain versions of the kernels; the default, cuda,
raises at once without a card. Weights come from
``torch.Generator(device).manual_seed(0)`` unless ``main`` is handed the
JAX example's (``convert.transformer_params``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    DataAware, Predicate, Query, TrivialPredicate, UDF, optimize,
)
from repro_torch.data.text import FOOD_WORDS, SERVICE_WORDS, make_reviews, topic_of_tokens
from repro_torch.kernels import launch
from repro_torch.models import transformer as tf
from repro_torch.models.params import stacked
from repro_torch.optim import AdamW, constant_schedule

MAX_LEN = 256


def pad(tokens_list):
    out = np.zeros((len(tokens_list), MAX_LEN), np.int32)
    for i, t in enumerate(tokens_list):
        out[i, : min(len(t), MAX_LEN)] = t[:MAX_LEN]
    return out


def train_probe(cfg, params, steps, seed=0, log=print):
    """Quick supervised fine-tune: next-token pools encode the topic. The
    batches are the reference's (numpy draws); ``params`` (a
    ``Transformer``) is updated in place and returned."""
    dev = params.embed.device
    opt = AdamW(schedule=constant_schedule(3e-3))
    state = opt.init(stacked(params, tf.param_shapes(cfg)))
    reviews = make_reviews(256, seed=seed + 100)
    toks = pad([r.tokens for r in reviews])
    # teacher forcing: predict the review's own tokens (topic words dominate)
    step = tf.make_train_step(cfg, opt)
    for i in range(steps):
        idx = np.random.default_rng(i).integers(0, len(reviews), 16)
        batch = {"tokens": torch.from_numpy(toks[idx]).to(dev),
                 "labels": torch.from_numpy(np.roll(toks[idx], -1, axis=1)).to(dev)}
        params, state, m = step(params, state, batch)
        if (i + 1) % 10 == 0:
            log(f"  probe step {i+1}: loss={float(m['loss']):.3f}")
    return params


def build_llm_udf(params, cfg):
    """The LLM predicate: a row's float32 log-softmax averaged over its
    live positions, mean over FOOD_WORDS less mean over SERVICE_WORDS. The
    copy in, the forward and the copy back run on the worker thread's own
    stream, in inference mode."""
    dev = params.embed.device
    food = torch.as_tensor(FOOD_WORDS, device=dev)
    service = torch.as_tensor(SERVICE_WORDS, device=dev)

    def score(tokens):
        logits = tf.forward(cfg, params, {"tokens": tokens})
        lp = torch.log_softmax(logits.to(torch.float32), -1)
        mask = (tokens > 0)[..., None]
        pooled = torch.where(mask, lp, 0.0).sum(1) / torch.clamp(
            mask.sum(1), min=1)
        return pooled[:, food].mean(-1) - pooled[:, service].mean(-1)

    def fn(d):
        with torch.inference_mode(), launch.thread_stream(dev):
            tokens = torch.from_numpy(np.asarray(d["tokens"])).to(dev)
            return score(tokens).cpu().numpy()

    return UDF(
        "LLM", fn=fn, columns=("tokens",), resource="cuda:0",
        proxy_cost=lambda d: float((d["tokens"] > 0).sum()),
    )


def source(reviews, chunk=64):
    for i in range(0, len(reviews), chunk):
        part = reviews[i:i + chunk]
        yield {
            "tokens": pad([r.tokens for r in part]),
            "rating": np.array([r.rating for r in part], np.int32),
            "_row_id": np.array([r.rid for r in part], np.int64),
        }


def run_query(llm, reviews, policy=None):
    """(matched row ids, plan, seconds) of the query; ``policy`` an eddy
    policy instance (the executor's default when None)."""
    q = Query(
        source=source(reviews),
        predicates=[Predicate("LLM_is_food", llm, compare=lambda s: s > 0)],
        trivial=[TrivialPredicate("rating", "<=", 1)],
    )
    kw = dict(laminar_policy_factory=DataAware, max_workers=4)
    if policy is not None:
        kw["policy"] = policy
    plan = optimize(q, executor_kwargs=kw)
    t0 = time.perf_counter()
    rows = plan.collect_rows()
    return rows["_row_id"].tolist(), plan, time.perf_counter() - t0


def oracle(llm, reviews, rows=64):
    """The query's answer from the whole table: every review with rating
    <= 1 scored by the predicate, in fixed batches of ``rows``."""
    kept = [r for r in reviews if r.rating <= 1]
    toks = pad([r.tokens for r in kept])
    scores = np.concatenate([llm({"tokens": toks[i:i + rows]})
                             for i in range(0, len(kept), rows)]) \
        if kept else np.zeros(0)
    return {r.rid for r, s in zip(kept, scores) if s > 0}


def main(argv=None, params=None) -> dict:
    """Runs UC4 and returns its numbers; ``params``, if given, are the
    decoder's initial weights (a ``Transformer`` on the device)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--reviews", type=int, default=200)
    ap.add_argument("--train-probe", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = launch.require_device(args.device)
    cfg = get_config("smollm-135m").reduce_for_smoke()
    if params is None:
        params = tf.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev)
    if args.train_probe:
        print(f"fine-tuning the LLM probe for {args.train_probe} steps...")
        params = train_probe(cfg, params, args.train_probe)

    reviews = make_reviews(args.reviews)
    llm = build_llm_udf(params, cfg)

    # probe accuracy on held-out reviews (vs actual token content)
    toks = pad([r.tokens for r in reviews])
    scores = llm({"tokens": toks})
    acc = np.mean([(s > 0) == (topic_of_tokens(r.tokens) == "food")
                   for s, r in zip(scores, reviews)])
    print(f"LLM probe accuracy vs content oracle: {acc:.2%}")

    matched, plan, dt = run_query(llm, reviews)
    print("plan:", " -> ".join(plan.description))
    print(f"\nmatched {len(matched)} negative food reviews in {dt:.2f}s")
    truth = {r.rid for r in reviews
             if r.rating <= 1 and topic_of_tokens(r.tokens) == "food"}
    inter = len(truth & set(matched))
    print(f"agreement with oracle topics: {inter}/{len(truth)} "
          f"(probe accuracy bounds this)")
    print("worker loads (data-aware balancing):",
          {k: round(v, 1) for k, v in plan.executor.stats.worker_load.items()})
    return {"params": params, "scores": scores, "matched": matched,
            "accuracy": float(acc), "cfg": cfg, "llm": llm,
            "reviews": reviews}


if __name__ == "__main__":
    main()
