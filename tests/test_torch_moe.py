"""The port's moe family (``repro_torch.models.moe``) against the JAX
package's.

The same numpy inputs, made from a seed, and the same parameters, drawn by
the JAX package and carried over by ``convert.model_params``, go through
both packages in float32. Logits, aux losses and caches are held to
``TOL_TIGHT`` (tests/test_kernels.py), with the JAX model's attention on
its XLA path and as the Pallas flash kernel in interpret mode:

* ``forward`` (logits and the aux loss), ``prefill`` and ``decode_step``
  at grok-1-314b and arctic-480b reduced for smoke tests (arctic keeps its
  dense residual MLP), at GQA groups of 6 and 7 (grok's and arctic's) at
  small head width, at arctic's 128 experts, at a capacity factor of 0.5
  (assignments dropped) and with a zero router (every logit tied);
* the routing itself: the port's indices equal the reference's
  ``kref.moe_topk_router`` exactly, the kept (token, expert) assignments
  equal the reference's capacity rule applied to them (so the dropped set
  is equal), and ``_moe_local``'s output matches; a zero router sends
  every token to experts 0 and 1 in both packages;
* ``cache_shapes``; ``param_count`` and ``active_param_count`` at full
  size are held in tests/test_torch_models.py with the other families';
* ``init_params`` (drawn a layer, and an expert, at a time);
* ``convert.model_params``' copy and refusals, ``transformer_params``'
  refusal of a moe config;
* the ``LLM(...)`` predicate, which scores through the dense decoder in
  both packages: grok's layers have no dense MLP, so it raises
  ``KeyError`` in both; arctic's dense residual MLP alone scores, equal in
  both.

Tests marked ``gpu`` run the router kernel at 8, 64, 65, 100 and 128
experts with ties against its plain version, and a grok-1 layer at full
width through the flash and router kernels against their plain versions,
and skip without a card.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.kernels import flash_attention, moe_router, ref
from repro_torch.launch import serve as port_serve
from repro_torch.models import attention, moe
from repro_torch.models import transformer as tf
from repro_torch.models.params import param_leaves
from repro_torch.models.registry import model_api

# small tensors: one intra-op thread, so these tests do not crowd the
# timing-sensitive executor tests running beside them
torch.set_num_threads(1)

TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)   # tests/test_kernels.py::TOL_TIGHT
TOL_BF16 = dict(rtol=8e-2, atol=8e-2)    # tests/test_kernels.py, bfloat16
# a float32 layer at grok-1's full width on the card: logits up to |8|
# from a 6,144-wide head product, the flash kernel's 3xTF32 products a few
# 1e-7 off the plain float32 ones (seen: 2.9e-5 on an H100)
F32_MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def reduced(arch, **changes):
    return dataclasses.replace(configs.get_config(arch).reduce_for_smoke(),
                               **changes)


MODELS = {
    # d 64, 4 heads of 16 on 2 kv heads, 4 experts, top-2, 2 layers
    "grok-reduced": lambda: reduced("grok-1-314b"),
    "arctic-reduced": lambda: reduced("arctic-480b"),
    # grok's GQA group (48 / 8) and arctic's (56 / 8) at small head width
    "grok-group-6": lambda: reduced("grok-1-314b", num_heads=12,
                                    num_kv_heads=2, head_dim=8),
    "arctic-group-7": lambda: reduced("arctic-480b", num_heads=14,
                                      num_kv_heads=2, head_dim=8),
    "arctic-128-experts": lambda: reduced("arctic-480b", num_experts=128),
    "grok-capacity-0.5": lambda: reduced("grok-1-314b", capacity_factor=0.5),
}
# the capacity factor is no parameter's dimension: one draw serves both
SAME_PARAMS = {"grok-capacity-0.5": "grok-reduced"}
IMPLS = ("xla", "pallas")   # the JAX model's attention: XLA or Pallas (interpret)

# name -> (model, prompt length, decode steps)
DECODE_CASES = {
    "grok-reduced": ("grok-reduced", 24, 3),
    "arctic-reduced": ("arctic-reduced", 24, 3),
    "grok-group-6": ("grok-group-6", 20, 2),
    "arctic-group-7": ("arctic-group-7", 20, 2),
    "arctic-128-experts": ("arctic-128-experts", 20, 2),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules the tests compare against (imported here,
    so that the ``gpu`` tests also run on a card host without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jax_configs
    from repro.kernels import ref as jax_ref
    from repro.launch import serve as jax_serve
    from repro.models import moe as jax_moe
    from repro.models import transformer as jax_tf
    from repro.models.registry import model_api as jax_model_api

    def cfg(port_cfg, **changes):
        """The JAX package's config of the same values."""
        return jax_configs.base.ModelConfig(
            **{**dataclasses.asdict(port_cfg), **changes})

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jax_configs,
                                 ref=jax_ref, serve=jax_serve, moe=jax_moe,
                                 tf=jax_tf, model_api=jax_model_api, cfg=cfg)


@pytest.fixture(scope="module")
def models(jx):
    """(JAX params, the port's model) per model name, drawn once by the
    JAX package."""
    cache = {}

    def get(name):
        name = SAME_PARAMS.get(name, name)
        if name not in cache:
            cfg = MODELS[name]()
            init = jx.moe.init_params
            params = jx.jax.jit(lambda key: init(jx.cfg(cfg), key))(
                jx.jax.random.key(0))   # one compile, not one a leaf
            cache[name] = (params, convert.model_params(
                jx.jax.tree.map(np.asarray, params), cfg, device="cpu"))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def zero_router(jx, models):
    """grok reduced with every router weight zero, in both packages."""
    params, _ = models("grok-reduced")
    layers = dict(params["layers"],
                  router=jx.jnp.zeros_like(params["layers"]["router"]))
    params = dict(params, layers=layers)
    return params, convert.model_params(jx.jax.tree.map(np.asarray, params),
                                        MODELS["grok-reduced"](), device="cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL_TIGHT):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# --------------------------------------------------------------------------- #
# forward, prefill and decode against the JAX package                         #
# --------------------------------------------------------------------------- #
FORWARD_MODELS = (*MODELS, "grok-zero-router")


def _cfg(name):
    return MODELS["grok-reduced" if name == "grok-zero-router" else name]()


@pytest.mark.parametrize("config,impl", [(m, i) for m in FORWARD_MODELS
                                         for i in IMPLS])
def test_forward_matches_the_reference(jx, models, zero_router, config,
                                       impl):
    cfg = _cfg(config)
    params, model = (zero_router if config == "grok-zero-router"
                     else models(config))
    toks = _tokens(2, 40, cfg.vocab_size)
    jcfg = jx.cfg(cfg, attention_impl=impl)
    want, want_aux = jx.jax.jit(lambda p, b: jx.moe.forward(jcfg, p, b))(
        params, {"tokens": jx.jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks)}
    got, got_aux = moe.forward(cfg, model, batch)
    assert tuple(got.shape) == want.shape == (2, 40, cfg.vocab_padded)
    assert got_aux.dtype == torch.float32 and got_aux.shape == ()
    _close(got, want)
    _close(got_aux, want_aux)
    assert (got[..., cfg.vocab_size:] == -1e9).all()
    if model.cfg == cfg:   # not where two configs share one draw
        logits, aux = model.forward(batch)
        assert logits.equal(got) and aux.equal(got_aux)


@pytest.mark.parametrize("case,impl", [(c, i) for c in DECODE_CASES
                                       for i in IMPLS])
def test_prefill_and_decode_match_the_reference(jx, models, case, impl):
    """Decode is held against the reference's decode, not against a full
    forward: a forward's capacity drops assignments that a decode step's
    (8 slots an expert for B tokens) does not."""
    name, prompt, steps = DECODE_CASES[case]
    cfg = MODELS[name]()
    jcfg = jx.cfg(cfg, attention_impl=impl)
    params, model = models(name)
    toks = _tokens(2, prompt + steps, cfg.vocab_size, seed=1)
    decode_j = jx.jax.jit(lambda p, c, b: jx.moe.decode_step(jcfg, p, c, b))
    cache_j, logits_j = jx.jax.jit(lambda p, b: jx.moe.prefill(
        jcfg, p, b, pad_cache_to=prompt + steps))(
            params, {"tokens": jx.jnp.asarray(toks[:, :prompt])})
    cache_t, logits_t = moe.prefill(cfg, model, {
        "tokens": torch.from_numpy(toks[:, :prompt])},
        pad_cache_to=prompt + steps)
    _close(logits_t, logits_j)
    for step in range(steps):
        tok = toks[:, prompt + step]
        cache_j, logits_j = decode_j(params, cache_j,
                                     {"token": jx.jnp.asarray(tok)})
        cache_t, logits_t = moe.decode_step(
            cfg, model, cache_t, {"token": torch.from_numpy(tok)})
        _close(logits_t, logits_j)
    assert sorted(cache_t) == sorted(cache_j) == ["k", "lengths", "v"]
    for key, value in cache_j.items():
        assert tuple(cache_t[key].shape) == value.shape, key
        assert str(cache_t[key].dtype).replace("torch.", "") == str(
            value.dtype)
        _close(cache_t[key], value)


# --------------------------------------------------------------------------- #
# routing: indices, kept and dropped assignments, the layer's output          #
# --------------------------------------------------------------------------- #
def _kept_by_rule(idx: np.ndarray, e: int, capacity: int) -> set:
    """The reference's capacity rule on (T, k) expert indices: each
    expert keeps its first ``capacity`` assignments in (token, slot)
    order. Returns the kept (token, expert) pairs."""
    seen = np.zeros(e, np.int64)
    kept = set()
    for t, row in enumerate(idx):
        for ex in row:
            if seen[ex] < capacity:
                kept.add((t, int(ex)))
            seen[ex] += 1
    return kept


@pytest.mark.parametrize("name", ["grok-reduced", "grok-capacity-0.5",
                                  "grok-zero-router", "arctic-128-experts"])
def test_routing_matches_the_reference(jx, models, zero_router, name):
    cfg = _cfg(name)
    params, model = (zero_router if name == "grok-zero-router"
                     else models(name))
    b, s, d = 2, 40, cfg.d_model
    t, e, k = b * s, cfg.num_experts, cfg.num_experts_per_tok
    x = np.random.default_rng(4).standard_normal((b, s, d)).astype(np.float32)
    capacity = moe._capacity(cfg, t)
    assert capacity == jx.moe._capacity(jx.cfg(cfg), t)
    lj = {key: v[0] for key, v in params["layers"].items()}
    lt = model.layers[0]

    logits_j = (jx.jnp.asarray(x.reshape(t, d)) @ lj["router"]).astype(
        jx.jnp.float32)
    w_j, idx_j = (np.asarray(a) for a in jx.ref.moe_topk_router(logits_j, k))
    logits_t = (torch.from_numpy(x.reshape(t, d)) @ lt["router"]).float()
    _close(logits_t, logits_j)
    w_t, idx_t = moe.moe_router_tk(logits_t, k)
    assert idx_t.dtype == torch.int32
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    _close(w_t, w_j)
    if name == "grok-zero-router":   # every logit tied: experts 0 and 1
        assert (idx_j == [0, 1]).all()

    tok, w = moe.dispatch(idx_t, w_t, e, capacity)
    assert tuple(tok.shape) == tuple(w.shape) == (e, capacity)
    kept = {(int(tk), ex) for ex in range(e) for tk in tok[ex] if tk < t}
    want_kept = _kept_by_rule(idx_j, e, capacity)
    assert kept == want_kept
    dropped = {(tt, int(ex)) for tt in range(t) for ex in idx_j[tt]} - kept
    assert bool(dropped) == (name in ("grok-capacity-0.5",
                                      "grok-zero-router"))
    assert int((tok == t).sum()) == e * capacity - len(kept)   # empty slots
    where = {(tt, int(ex)): w_j[tt, j] for tt in range(t)
             for j, ex in enumerate(idx_j[tt])}
    np.testing.assert_allclose(
        [float(w[ex, c]) for ex in range(e) for c in range(capacity)
         if tok[ex, c] < t],
        [where[(int(tok[ex, c]), ex)] for ex in range(e)
         for c in range(capacity) if tok[ex, c] < t], **TOL_TIGHT)

    y_j, aux_j = jx.moe._moe_local(
        jx.jnp.asarray(x), lj["router"], lj["e_gate"], lj["e_up"],
        lj["e_down"], cfg=jx.cfg(cfg), capacity=capacity, axis=None,
        ep=False)
    y_t, aux_t = moe._moe_local(
        torch.from_numpy(x), lt["router"], lt["e_gate"], lt["e_up"],
        lt["e_down"], cfg=cfg, capacity=capacity)
    _close(y_t, y_j)
    _close(aux_t, aux_j)
    _close(moe.aux_loss(logits_t, idx_t), aux_j)


def test_plain_router_matches_the_reference_at_128_experts(jx):
    """The plain router (the CPU path of ``moe_router_tk``) at arctic's
    128 experts with ties: a row of equal logits, a row with two equal
    maxima and a row with equal second places."""
    logits = np.random.default_rng(6).standard_normal((64, 128)).astype(
        np.float32) * 1.6
    logits[0] = 0.25
    logits[1, [7, 90]] = 9.0
    logits[2, 100] = 9.0
    logits[2, [31, 64]] = 8.0
    w_j, idx_j = jx.ref.moe_topk_router(jx.jnp.asarray(logits), 2)
    w_t, idx_t = moe_router.moe_router_tk(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(idx_t[:3].numpy(),
                                  [[0, 1], [7, 90], [100, 31]])
    _close(w_t, w_j)
    with pytest.raises(ValueError, match="1 <= k <= E"):
        moe_router.moe_router_tk(torch.from_numpy(logits), 129)


# --------------------------------------------------------------------------- #
# cache shapes, parameters and the converters                                 #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
@pytest.mark.parametrize("seq_len", [1024, 8192])
def test_cache_shapes_match_the_reference(jx, arch, seq_len):
    jcfg = jx.configs.get_config(arch)
    want, _ = jx.model_api(jcfg).cache_shapes(jcfg, 4, seq_len)
    cfg = configs.get_config(arch)
    got = model_api(cfg).cache_shapes(cfg, 4, seq_len)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_registry_and_param_shapes_match_the_reference(jx, arch):
    cfg = configs.get_config(arch)
    assert model_api(cfg) is moe
    want = {k: (v.shape, str(v.dtype)) for k, v in param_leaves(
        jx.moe.param_shapes(jx.configs.get_config(arch)))}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in param_leaves(moe.param_shapes(cfg))}
    assert got == want
    assert ("layers.w_gate" in got) == cfg.moe_dense_residual


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_draws_a_piece_at_a_time(dtype):
    """Every leaf of two or more dimensions drawn (std 0.02, within ±0.04),
    the 1-d final norm zero, each expert its own draw, the same seed the
    same model, and a model cut to fewer layers the first layers of a
    deeper one."""
    cfg = reduced("arctic-480b", dtype=dtype)
    a = moe.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = moe.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert type(a) is moe.MoE
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert pa.dtype == getattr(torch, dtype) and pa.equal(pb), name
        assert not pa.requires_grad
        if name == "final_norm":
            assert (pa == 0).all()
        else:
            assert 0.015 < float(pa.float().std()) < 0.025, name
            # 2 std, rounded up to bf16 at most
            assert float(pa.float().abs().max()) <= 0.04 * (1 + 2 ** -8), name
    experts = a.layers[0]["e_gate"]
    assert not experts[0].equal(experts[1])
    assert not a.layers[0]["e_up"].equal(a.layers[1]["e_up"])
    assert sum(p.numel() for p in a.parameters()) == moe.param_count(cfg)
    deeper = moe.init_params(dataclasses.replace(cfg, num_layers=3),
                             torch.Generator().manual_seed(0), device="cpu")
    for name, p in a.named_parameters():
        assert p.equal(deeper.get_parameter(name)), name


@pytest.mark.parametrize("name", ["grok-reduced", "arctic-reduced"])
def test_model_params_is_a_copy(jx, models, name):
    cfg = MODELS[name]()
    params, model = models(name)
    assert type(model) is moe.MoE
    for key, value in param_leaves(jx.jax.tree.map(np.asarray, params)):
        first, *rest = key.split(".")
        target = getattr(model, first)
        got = torch.stack([layer[rest[0]] for layer in target]) if rest \
            else target
        np.testing.assert_array_equal(got.numpy(), value, err_msg=key)
    assert sum(p.numel() for p in model.parameters()) == \
        moe.param_count(cfg)


def test_model_params_refuses_missing_extra_and_misshapen_leaves(jx, models):
    cfg = MODELS["grok-reduced"]()
    params = jx.jax.tree.map(np.asarray, models("grok-reduced")[0])
    layers = {k: v for k, v in params["layers"].items() if k != "e_gate"}
    with pytest.raises(ValueError, match="missing.*layers.e_gate"):
        convert.model_params({**params, "layers": layers}, cfg, device="cpu")
    layers = dict(params["layers"],
                  w_gate=np.zeros((2, 64, 128), np.float32))
    with pytest.raises(ValueError, match="extra.*layers.w_gate"):
        convert.model_params({**params, "layers": layers}, cfg, device="cpu")
    layers = dict(params["layers"], router=params["layers"]["router"][..., :3])
    with pytest.raises(ValueError, match="layers.router"):
        convert.model_params({**params, "layers": layers}, cfg, device="cpu")
    with pytest.raises(ValueError, match="model_params"):
        convert.transformer_params(params, cfg, device="cpu")


# --------------------------------------------------------------------------- #
# the LLM(...) predicate scores through the dense decoder in both packages    #
# --------------------------------------------------------------------------- #
def test_llm_predicate_raises_for_grok_in_both_packages(jx, models):
    """The reference's ``score`` calls ``transformer.forward`` whatever the
    family; grok's layers have no ``w_gate``, so it raises ``KeyError``,
    and the port's the same."""
    cfg = MODELS["grok-reduced"]()
    params, model = models("grok-reduced")
    toks = _tokens(2, 512, cfg.vocab_size, seed=3)
    udf_j = jx.serve.build_llm_udf(params=params, cfg=jx.cfg(cfg))
    udf_t = port_serve.build_llm_udf(params=model, cfg=cfg, device="cpu")
    with pytest.raises(KeyError, match="w_gate"):
        udf_j.fn({"tokens": toks})
    with pytest.raises(KeyError, match="w_gate"):
        udf_t.fn({"tokens": toks})


def test_llm_predicate_scores_arctic_through_its_dense_mlp_in_both_packages(
        jx, models, monkeypatch):
    """arctic's layers keep the dense residual MLP, so the reference's
    ``score`` runs the dense decoder on it and ignores the experts; the
    port's does the same: the decoder's logits within TOL_TIGHT, and the
    scores (differences of sums over the live positions, summed in
    another order in each package) within the LLM tests' SCORE_TOL
    (tests/test_torch_llm_serve.py)."""
    cfg = MODELS["arctic-reduced"]()
    params, model = models("arctic-reduced")
    toks = _tokens(3, 512, cfg.vocab_size, seed=3)
    for row, live in enumerate((60, 120, 200)):
        toks[row, live:] = 0   # padding past each review
    monkeypatch.setattr(moe, "dispatch", None)   # the experts stay unused
    want = jx.jax.jit(lambda p, b: jx.tf.forward(jx.cfg(cfg), p, b))(
        params, {"tokens": jx.jnp.asarray(toks)})
    _close(tf.forward(cfg, model, {"tokens": torch.from_numpy(toks)}), want)
    want = jx.serve.build_llm_udf(params=params, cfg=jx.cfg(cfg)).fn(
        {"tokens": toks})
    got = port_serve.build_llm_udf(params=model, cfg=cfg, device="cpu").fn(
        {"tokens": toks})
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("e", [8, 64, 65, 100, 128])
def test_router_kernel_matches_its_plain_version_on_card(card, e):
    """One thread a row up to 64 experts, one warp a row above: indices
    exact, weights within TOL_TIGHT, with tied rows."""
    logits = np.random.default_rng(e).standard_normal((1000, e)).astype(
        np.float32) * 1.6
    logits[0] = 0.5
    logits[1, [3, e - 2]] = 9.0
    logits[2, e - 1] = 9.0
    logits[2, [1, e // 2]] = 8.0
    x = torch.from_numpy(logits).to(card)
    before = moe_router.launches
    for k in (1, 2, 8):
        w, idx = moe_router.moe_router_tk(x, k)
        w_p, idx_p = ref.moe_topk_router(x, k)
        torch.cuda.synchronize()
        assert idx.dtype == torch.int32 and idx.equal(idx_p), k
        _close(w, w_p)
    assert moe_router.launches - before == 3
    assert idx[:3, :2].tolist() == [[0, 1], [3, e - 2], [e - 1, 1]]
    with pytest.raises(ValueError, match="at most 128"):
        moe_router.moe_router_tk(torch.zeros((4, 129), device=card), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grok_layer_through_the_kernels_on_card(card, monkeypatch, dtype):
    """grok-1 at full width, 1 layer: a forward at (2, 256) launches the
    flash and router kernels once each and agrees with the same forward
    through their plain versions: every logit within F32_MODEL_TOL in
    float32;
    in bf16, where a bf16 ulp in the attention moves some tokens across a
    top-2 boundary (and, through capacity, others' slots), at least 95% of
    the tokens keep their experts and those tokens' logits hold
    TOL_BF16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config("grok-1-314b"),
                              num_layers=1, dtype=dtype)
    model = moe.init_params(cfg, torch.Generator(card).manual_seed(0),
                            device=card)
    toks = torch.from_numpy(_tokens(2, 256, cfg.vocab_size)).to(card)
    routes = []
    dispatch = moe.dispatch

    def recorded(*args):
        tok, w = dispatch(*args)
        routes.append(tok)
        return tok, w

    monkeypatch.setattr(moe, "dispatch", recorded)
    before = (flash_attention.launches, moe_router.launches)
    with torch.inference_mode():
        got, aux = moe.forward(cfg, model, {"tokens": toks})
        torch.cuda.synchronize()
        launched = (flash_attention.launches - before[0],
                    moe_router.launches - before[1])
        monkeypatch.setattr(moe, "moe_router_tk", ref.moe_topk_router)
        monkeypatch.setattr(attention, "flash_attention_bshd",
                            ref.flash_attention_bshd)
        want, want_aux = moe.forward(cfg, model, {"tokens": toks})
    assert launched == (1, 1)
    assert bool(torch.isfinite(got).all())
    if dtype == "float32":
        _close(got, want, F32_MODEL_TOL)
        _close(aux, want_aux)
        return

    def experts(tok):   # each token's kept experts
        t = 2 * 256
        out = [set() for _ in range(t + 1)]
        for ex, row in enumerate(tok.tolist()):
            for tk in row:
                out[tk].add(ex)
        return out[:t]

    same = torch.tensor([a == b for a, b in zip(*map(experts, routes))],
                        device=card).reshape(2, 256)
    assert float(same.float().mean()) >= 0.95
    _close(got[same], want[same], TOL_BF16)
