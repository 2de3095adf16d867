"""The port's LLM(...) predicate and serving CLI
(``repro_torch.launch.serve.build_llm_udf`` and ``main``) against the JAX
package's.

Both packages get the JAX package's default LLM weights (SmolLM-135M
reduced for smoke tests, drawn from ``jax.random.key(0)``), the port's
through ``convert.transformer_params``, and the same reviews:

* the scores of every row the query scores agree within ``SCORE_TOL``, and
  the smallest decision margin of the data exceeds that tolerance;
* the CLI's query (``LLM_is_food`` with ``rating <= 1`` pushed down, 10-row
  batches, ``DataAware``, 4 workers, on a ``QueryService(max_concurrent=1)``)
  returns the JAX package's row ids and ``report.rows`` under every eddy
  policy;
* an LLM call with timing hooks connected records no ``flash_attention``
  launch event in either package (the JAX package's forward is jitted; the
  port's model calls the kernel's wrapper, not ``kernel_call``);
* ``build_llm_udf()`` needs a card unless it is given ``device="cpu"``, and
  ``main`` serves the query on the CPU when asked.

The test marked ``gpu`` serves the query on the card at SmolLM's full
widths cut to 2 layers, and skips without one.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as port_core
import repro_torch.launch.serve as port_serve
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.text import make_reviews
from repro_torch.kernels import flash_attention, launch
from repro_torch.models import transformer as tf

# small tensors: one intra-op thread, so these tests do not crowd the
# timing-sensitive executor tests running beside them
torch.set_num_threads(1)

# A score is a difference of two means of sums over up to 512 positions of
# float32 log-probabilities near -log(257): sums near -2,800, where
# float32's spacing is 2.4e-4. Logits are held to TOL_TIGHT (rtol 1e-4,
# atol 1e-5; tests/test_torch_models.py); the scores, summed in another order in each
# package, to this (seen: 1.9e-5).
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
REVIEWS = 200                            # the CLI's default
POLICIES = sorted(port_core.policies.EDDY_POLICIES)
CFG = get_config("smollm-135m").reduce_for_smoke()   # the CLI's default model


@pytest.fixture(scope="module")
def llm():
    """The JAX package's default LLM predicate and the port's, on the CPU,
    with the same weights (JAX is imported here, so that the ``gpu`` test
    also runs on a card host without it)."""
    jax = pytest.importorskip("jax")
    import repro.core as jax_core
    import repro.launch.serve as jax_serve
    from repro.configs import get_config as jax_get_config
    from repro.data.text import make_reviews as jax_reviews
    from repro.kernels import launch as jax_launch
    from repro.models import transformer as jax_tf

    cfg = jax_get_config("smollm-135m").reduce_for_smoke()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(CFG)
    params = jax_tf.init_params(cfg, jax.random.key(0))
    model = convert.transformer_params(jax.tree.map(np.asarray, params), CFG,
                                       device="cpu")
    return dict(cfg=cfg, params=params, model=model, core=jax_core,
                serve=jax_serve, reviews=jax_reviews, launch=jax_launch,
                jax=jax_serve.build_llm_udf(params=params, cfg=cfg),
                port=port_serve.build_llm_udf(params=model, cfg=CFG,
                                              device="cpu"))


def _table(reviews):
    """The CLI's rows (``review_source``) as one batch."""
    parts = list(port_serve.review_source(reviews))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _serve(pkg_core, serve, llm_udf, reviews, policy):
    """The CLI's query (serve.main) on the given package, one policy."""
    pred = pkg_core.Predicate("LLM_is_food", llm_udf, compare=lambda s: s > 0)
    q = pkg_core.Query(
        source=serve.review_source(reviews), predicates=[pred],
        trivial=[pkg_core.TrivialPredicate("rating", "<=", 1)],
        batch_rows=10)
    with serve.QueryService(max_concurrent=1) as service:
        handle = service.submit(
            [pred], pkg_core.batches_of(q),
            policy=pkg_core.policies.EDDY_POLICIES[policy](),
            laminar_policy_factory=pkg_core.policies.DataAware,
            max_workers=4)
        rep = handle.result(timeout=300)
    assert rep.state == "DONE", rep.error
    return rep


def test_scores_match_the_reference_with_margins(llm):
    table = _table(make_reviews(REVIEWS))
    batch = {"tokens": table["tokens"][table["rating"] <= 1]}
    want = np.asarray(llm["jax"].fn(batch), np.float32)
    got = llm["port"].fn(batch)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    margin = np.abs(want)
    assert (margin > SCORE_TOL["atol"] + SCORE_TOL["rtol"] * margin).all(), \
        margin.min()
    assert 0 < (want > 0).sum() < len(want)   # both answers occur


@pytest.mark.parametrize("policy", POLICIES)
def test_cli_query_returns_the_reference_rows(llm, policy):
    port = _serve(port_core, port_serve, llm["port"], make_reviews(REVIEWS),
                  policy)
    ref = _serve(llm["core"], llm["serve"], llm["jax"],
                 llm["reviews"](REVIEWS), policy)
    assert sorted(map(int, port.row_ids)) == sorted(map(int, ref.row_ids))
    assert port.rows == ref.rows > 0
    # the board profiles the predicate, and no kernel inside the model
    assert port.board_predicates == ref.board_predicates == ("LLM_is_food",)


def test_cli_query_rows_are_the_whole_table_oracle(llm):
    reviews = make_reviews(REVIEWS)
    table = _table(reviews)
    low = table["rating"] <= 1
    scores = llm["port"].fn({"tokens": table["tokens"][low]})
    want = sorted(table["_row_id"][low][scores > 0].tolist())
    rep = _serve(port_core, port_serve, llm["port"], reviews, "hydro")
    assert sorted(map(int, rep.row_ids)) == want


def test_llm_call_records_no_flash_attention_event(llm):
    """The port's model calls the flash wrapper directly, so hooks see no
    launch; the JAX package's jitted forward, with its attention on the
    Pallas kernel, records none either."""
    batch = {"tokens": _table(make_reviews(40))["tokens"][:10]}
    events = []
    hook = launch.add_launch_hook(events.append)
    try:
        llm["port"].fn(batch)
    finally:
        launch.remove_launch_hook(hook)
    assert events == []
    cfg = dataclasses.replace(llm["cfg"], attention_impl="pallas")
    jax_udf = llm["serve"].build_llm_udf(params=llm["params"], cfg=cfg)
    jax_events = []
    hook = llm["launch"].add_launch_hook(jax_events.append)
    try:
        jax_udf.fn(batch)
    finally:
        llm["launch"].remove_launch_hook(hook)
    assert jax_events == []


def test_llm_udf_needs_a_card_unless_given_the_cpu(llm):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.build_llm_udf()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.build_llm_udf(params=llm["model"], cfg=CFG)
    udf = port_serve.build_llm_udf(device="cpu")
    assert udf.name == "LLM" and udf.resource == "cuda:0"
    assert udf.columns == ("tokens",)
    toks = np.zeros((2, port_serve.MAX_LEN), np.int32)
    toks[:, :5] = 12
    assert udf.proxy_cost({"tokens": toks}) == 10.0


def test_llm_udf_refuses_token_ids_outside_the_vocabulary(llm):
    toks = np.zeros((1, port_serve.MAX_LEN), np.int32)
    toks[0, 3] = CFG.vocab_size
    with pytest.raises(ValueError, match="token ids"):
        llm["port"].fn({"tokens": toks})


def test_main_serves_the_query_on_the_cpu(capsys):
    port_serve.main(["--device", "cpu", "--reviews", "100", "--policy",
                     "selectivity"])
    out = capsys.readouterr().out
    # the default weights: SmolLM reduced from torch's seed 0, on the CPU
    model = tf.init_params(CFG, torch.Generator().manual_seed(0),
                           device="cpu")
    table = _table(make_reviews(100))
    low = table["rating"] <= 1
    udf = port_serve.build_llm_udf(params=model, cfg=CFG, device="cpu")
    n = int((udf.fn({"tokens": table["tokens"][low]}) > 0).sum())
    assert f"[serve] matched {n} negative food reviews" in out
    assert "[serve] routing:" in out and "[serve] service:" in out


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
@pytest.mark.gpu
def test_query_on_card_matches_the_cpu():
    """SmolLM's full widths cut to 2 layers, in float32 on the card (the
    flash kernel in 3xTF32) and on the CPU: the same rows outside the
    margin of the score difference between the two, under every policy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("smollm-135m"), num_layers=2,
                              dtype="float32")
    model = tf.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    cpu = port_serve.build_llm_udf(params=model, cfg=cfg, device="cpu")
    # Module.to moves the parameters in place: the card gets a copy
    card = port_serve.build_llm_udf(params=copy.deepcopy(model).to("cuda"),
                                    cfg=cfg, device="cuda")
    reviews = make_reviews(REVIEWS)
    table = _table(reviews)
    low = table["rating"] <= 1
    toks = table["tokens"][low]
    # 10 rows a call, as the query makes them: a call's float32 logits
    # take 1 GB at SmolLM's vocabulary
    want, got = (np.concatenate([udf.fn({"tokens": toks[i:i + 10]})
                                 for i in range(0, len(toks), 10)])
                 for udf in (cpu, card))
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    margin = 4 * float(np.abs(got - want).max()) + SCORE_TOL["atol"]
    sure = np.abs(want) > margin
    ids = table["_row_id"][low]
    for policy in POLICIES:
        before = flash_attention.launches
        rep = _serve(port_core, port_serve, card, reviews, policy)
        assert flash_attention.launches - before >= cfg.num_layers
        rows = set(map(int, rep.row_ids))
        assert {int(i) for i in ids[sure & (want > 0)]} <= rows
        assert not rows & {int(i) for i in ids[sure & (want <= 0)]}
