"""The port's ssm, hybrid and encdec families (``repro_torch.models.ssm``,
``hybrid``, ``encdec``) against the JAX package's.

The same numpy inputs, made from a seed, and the same parameters, drawn by
the JAX package and carried over by ``convert.model_params``, go through
both packages in float32. Logits and caches are held to ``TOL_TIGHT``
(tests/test_kernels.py), with the JAX model's kernels on its XLA path and
as Pallas kernels in interpret mode (ssd, rglru, flash):

* ``forward``, ``prefill`` and ``decode_step`` at mamba2-370m,
  recurrentgemma-9b and whisper-small reduced for smoke tests; mamba2's
  full widths (H 32, P 64, N 128) at 2 layers under XLA; a reduced hybrid
  with recurrentgemma's attention heads (16 query heads on 1 kv head of
  256) and a window of 16, with a rest layer, at prompts longer and
  shorter than the window; whisper reduced with 128 frames, which the
  Pallas path needs (its non-causal flash refuses an encoder that is not
  a multiple of its 128-row block, so the reduced config's 8 frames run
  under XLA only);
* ``cache_shapes``, and the JAX package's three "decode matches forward"
  checks (tests/test_models_smoke.py) on the port alone;
* ``convert.model_params``' copies and refusals, and the converters'
  default device (the card);
* the ``LLM(...)`` predicate, which scores through the dense decoder in
  both packages and so raises for an ssm or hybrid config in both.

Tests marked ``gpu`` run each family through the hand-written kernels on
the card against the same forward through their plain versions, and skip
without one.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.kernels import flash_attention, ref, rglru, ssd
from repro_torch.launch import serve as port_serve
from repro_torch.models import attention, hybrid, ssm
from repro_torch.models.params import param_leaves
from repro_torch.models.registry import model_api

# small tensors: one intra-op thread, so these tests do not crowd the
# timing-sensitive executor tests running beside them
torch.set_num_threads(1)

TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)   # tests/test_kernels.py::TOL_TIGHT
TOL_BF16 = dict(rtol=8e-2, atol=8e-2)    # tests/test_kernels.py, bfloat16
FRAME_SEED = 7


def reduced(arch, **changes):
    return dataclasses.replace(configs.get_config(arch).reduce_for_smoke(),
                               **changes)


MODELS = {
    "mamba-reduced": lambda: reduced("mamba2-370m"),
    "mamba-full-widths-2-layers": lambda: dataclasses.replace(
        configs.get_config("mamba2-370m"), num_layers=2, dtype="float32"),
    # 1 group of (rg, rg, local attention), window 32
    "rgemma-reduced": lambda: reduced("recurrentgemma-9b"),
    # recurrentgemma's attention heads at small width, a group and a rest
    # layer, window 16
    "rgemma-heads": lambda: reduced("recurrentgemma-9b", num_layers=4,
                                    num_heads=16, num_kv_heads=1,
                                    head_dim=256, local_window=16),
    "whisper-reduced": lambda: reduced("whisper-small"),          # 8 frames
    "whisper-aligned": lambda: reduced("whisper-small", num_frames=128),
}
# the frame count is no parameter's dimension: one draw serves both
SAME_PARAMS = {"whisper-aligned": "whisper-reduced"}

# (model, impl) pairs: the Pallas flash path refuses the 8-frame encoder,
# and mamba2's full widths run under XLA only (time)
FORWARD_CASES = [
    ("mamba-reduced", "xla"), ("mamba-reduced", "pallas"),
    ("mamba-full-widths-2-layers", "xla"),
    ("rgemma-reduced", "xla"), ("rgemma-reduced", "pallas"),
    ("rgemma-heads", "xla"), ("rgemma-heads", "pallas"),
    ("whisper-reduced", "xla"),
    ("whisper-aligned", "xla"), ("whisper-aligned", "pallas"),
]

# name -> (model, prompt length, decode steps, impls); rgemma-reduced has a
# window of 32 and rgemma-heads one of 16: a prompt of 40 wraps the ring,
# one of 12 leaves it short (a ring as long as the prompt)
DECODE_CASES = {
    "mamba-reduced": ("mamba-reduced", 24, 3, ("xla", "pallas")),
    "mamba-full-widths-2-layers": ("mamba-full-widths-2-layers", 16, 2,
                                   ("xla",)),
    "rgemma-reduced-wrapped": ("rgemma-reduced", 40, 3, ("xla", "pallas")),
    "rgemma-heads-wrapped": ("rgemma-heads", 40, 2, ("xla", "pallas")),
    "rgemma-heads-short": ("rgemma-heads", 12, 2, ("xla", "pallas")),
    "whisper-reduced": ("whisper-reduced", 16, 3, ("xla",)),
    "whisper-aligned": ("whisper-aligned", 16, 2, ("xla", "pallas")),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules the tests compare against (imported here,
    so that the ``gpu`` tests also run on a card host without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jax_configs
    from repro.launch import serve as jax_serve
    from repro.models.registry import model_api as jax_model_api

    def cfg(port_cfg, **changes):
        """The JAX package's config of the same values."""
        return jax_configs.base.ModelConfig(
            **{**dataclasses.asdict(port_cfg), **changes})

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jax_configs,
                                 serve=jax_serve, model_api=jax_model_api,
                                 cfg=cfg)


@pytest.fixture(scope="module")
def models(jx):
    """(JAX params, the port's model) per model name, drawn once by the
    JAX package."""
    cache = {}

    def get(name):
        name = SAME_PARAMS.get(name, name)
        if name not in cache:
            cfg = MODELS[name]()
            init = jx.model_api(cfg).init_params
            params = jx.jax.jit(lambda key: init(jx.cfg(cfg), key))(
                jx.jax.random.key(0))   # one compile, not one a leaf
            cache[name] = (params, convert.model_params(
                jx.jax.tree.map(np.asarray, params), cfg, device="cpu"))
        return cache[name]

    return get


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _frames(cfg, b):
    return np.random.default_rng(FRAME_SEED).standard_normal(
        (b, cfg.num_frames, cfg.d_model)).astype(np.float32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL_TIGHT):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _batches(jx, cfg, toks, b):
    """The same batch for both packages (frames for an encdec config)."""
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = _frames(cfg, b)
    return ({k: jx.jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# --------------------------------------------------------------------------- #
# forward, prefill and decode against the JAX package                         #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("config,impl", FORWARD_CASES)
def test_forward_matches_the_reference(jx, models, config, impl):
    cfg = MODELS[config]()
    params, model = models(config)
    s = 128 if cfg.family == "ssm" else 40   # ssm: two chunks of 64
    toks = _tokens(2, s, cfg.vocab_size)
    batch_j, batch_t = _batches(jx, cfg, toks, 2)
    jcfg = jx.cfg(cfg, attention_impl=impl)
    want = jx.jax.jit(lambda p, b: jx.model_api(cfg).forward(jcfg, p, b))(
        params, batch_j)
    got = model_api(cfg).forward(cfg, model, batch_t)
    assert tuple(got.shape) == want.shape == (2, s, cfg.vocab_padded)
    _close(got, want)
    assert (got[..., cfg.vocab_size:] == -1e9).all()
    assert model.forward(batch_t).equal(got)


@pytest.mark.parametrize("case,impl", [(c, i) for c, v in DECODE_CASES.items()
                                       for i in v[3]])
def test_prefill_and_decode_match_the_reference(jx, models, case, impl):
    name, prompt, steps, _ = DECODE_CASES[case]
    cfg = MODELS[name]()
    jcfg = jx.cfg(cfg, attention_impl=impl)
    api_j, api_t = jx.model_api(cfg), model_api(cfg)
    params, model = models(name)
    toks = _tokens(2, prompt + steps, cfg.vocab_size, seed=1)
    batch_j, batch_t = _batches(jx, cfg, toks[:, :prompt], 2)
    kw = {"pad_cache_to": prompt + steps} if cfg.family == "encdec" else {}
    # jitted: the decode steps share one compile
    decode_j = jx.jax.jit(lambda p, c, b: api_j.decode_step(jcfg, p, c, b))
    cache_j, logits_j = jx.jax.jit(
        lambda p, b: api_j.prefill(jcfg, p, b, **kw))(params, batch_j)
    cache_t, logits_t = api_t.prefill(cfg, model, batch_t, **kw)
    _close(logits_t, logits_j)
    for step in range(steps):
        tok = toks[:, prompt + step]
        cache_j, logits_j = decode_j(params, cache_j,
                                     {"token": jx.jnp.asarray(tok)})
        cache_t, logits_t = api_t.decode_step(
            cfg, model, cache_t, {"token": torch.from_numpy(tok)})
        _close(logits_t, logits_j)
    want = dict(param_leaves(cache_j))
    got = dict(param_leaves(cache_t))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert tuple(got[key].shape) == value.shape, key
        assert str(got[key].dtype).replace("torch.", "") == str(value.dtype)
        _close(got[key], value)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b",
                                  "whisper-small"])
@pytest.mark.parametrize("seq_len", [1024, 8192])
def test_cache_shapes_match_the_reference(jx, arch, seq_len):
    want, _ = jx.model_api(jx.configs.get_config(arch)).cache_shapes(
        jx.configs.get_config(arch), 4, seq_len)
    cfg = configs.get_config(arch)
    got = model_api(cfg).cache_shapes(cfg, 4, seq_len)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in param_leaves(got)} == {
        k: (v.shape, str(v.dtype)) for k, v in param_leaves(want)}


# --------------------------------------------------------------------------- #
# decode matches forward (the JAX package's smoke checks, on the port)        #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,tol", [("mamba2-370m", 5e-3),
                                      ("recurrentgemma-9b", 5e-3),
                                      ("whisper-small", 2e-3)])
def test_decode_matches_forward(arch, tol):
    """tests/test_models_smoke.py's test_{ssm,hybrid,encdec}_decode_matches_
    forward on the port: a prefill of 32 tokens, one decode step, against
    the full forward's last position, with the reference's tolerances."""
    b, s = 2, 32
    cfg = reduced(arch)
    api = model_api(cfg)
    model = api.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = (torch.arange(b * (s + 1), dtype=torch.int32).reshape(b, s + 1)
            % cfg.vocab_size)
    batch, kw = {"tokens": toks[:, :s]}, {}
    if cfg.family == "encdec":
        batch["frames"] = torch.full((b, cfg.num_frames, cfg.d_model), 0.1)
        kw["pad_cache_to"] = s + 4
    cache, _ = api.prefill(cfg, model, batch, **kw)
    _, dec_logits = api.decode_step(cfg, model, cache, {"token": toks[:, s]})
    full = api.forward(cfg, model, {**batch, "tokens": toks})
    np.testing.assert_allclose(_np(dec_logits), _np(full[:, -1]), rtol=tol,
                               atol=tol)


# --------------------------------------------------------------------------- #
# model_params and the converters                                             #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["mamba-reduced", "rgemma-heads",
                                  "whisper-reduced"])
def test_model_params_is_a_copy(jx, models, name):
    cfg = MODELS[name]()
    params, model = models(name)
    assert type(model) is model_api(cfg).Model
    leaves = dict(param_leaves(jx.jax.tree.map(np.asarray, params)))
    for key, value in leaves.items():
        first, *rest = key.split(".")
        target = getattr(model, first)
        if rest:   # stacked over the layers
            layers = []
            for layer in target:
                for part in rest:
                    layer = layer[part]
                layers.append(layer)
            got = (torch.stack(layers) if layers
                   else torch.empty(value.shape))
        else:
            got = target
        np.testing.assert_array_equal(got.numpy(), value, err_msg=key)
    assert sum(p.numel() for p in model.parameters()) == \
        model_api(cfg).param_count(cfg)


def test_model_params_refuses_missing_extra_and_misshapen_leaves(jx, models):
    cfg = MODELS["rgemma-heads"]()
    params = jx.jax.tree.map(np.asarray, models("rgemma-heads")[0])
    groups = dict(params["groups"], rg2={
        k: v for k, v in params["groups"]["rg2"].items() if k != "a_param"})
    with pytest.raises(ValueError, match="missing.*groups.rg2.a_param"):
        convert.model_params({**params, "groups": groups}, cfg, device="cpu")
    rest = dict(params["rest"], w_q=np.zeros((1, 64, 64), np.float32))
    with pytest.raises(ValueError, match="extra.*rest.w_q"):
        convert.model_params({**params, "rest": rest}, cfg, device="cpu")
    attn = dict(params["groups"]["attn"],
                wq=params["groups"]["attn"]["wq"][:, :, :8])
    groups = dict(params["groups"], attn=attn)
    with pytest.raises(ValueError, match="groups.attn.wq"):
        convert.model_params({**params, "groups": groups}, cfg, device="cpu")
    with pytest.raises(ValueError, match="model_params"):
        convert.transformer_params(params, cfg, device="cpu")


def _zeros(shapes):
    """A parameter pytree of zeros in the shapes of a ``param_shapes``."""
    return {k: _zeros(v) if isinstance(v, dict) else np.zeros(v.shape,
                                                               np.float32)
            for k, v in shapes.items()}


def test_converters_default_to_the_card():
    """Without ``device`` every converter puts its tensors on the card, so
    on a host without one each raises at once."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    mamba, dense = reduced("mamba2-370m"), reduced("smollm-135m")
    table = np.zeros((4, 3), np.float32)
    for call in (lambda: convert.model_params(
                     _zeros(ssm.param_shapes(mamba)), mamba),
                 lambda: convert.transformer_params(
                     _zeros(model_api(dense).param_shapes(dense)), dense),
                 lambda: convert.hsv_ranges(np.zeros((9, 6))),
                 lambda: convert.embedding_table(table)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = convert.model_params(_zeros(ssm.param_shapes(mamba)), mamba,
                                 device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


# --------------------------------------------------------------------------- #
# the LLM(...) predicate scores through the dense decoder in both packages    #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_llm_predicate_raises_for_ssm_and_hybrid_in_both_packages(
        jx, models, arch):
    """The reference's ``score`` calls ``transformer.forward`` whatever the
    config's family, so an ssm or hybrid model's parameters fail it (a
    KeyError there); the port's does the same, and serves no family the
    reference cannot."""
    name = {"mamba2-370m": "mamba-reduced",
            "recurrentgemma-9b": "rgemma-reduced"}[arch]
    cfg = reduced(arch)
    params, model = models(name)
    toks = _tokens(2, 512, cfg.vocab_size, seed=3)
    udf_j = jx.serve.build_llm_udf(params=params, cfg=jx.cfg(cfg))
    udf_t = port_serve.build_llm_udf(params=model, cfg=cfg, device="cpu")
    with pytest.raises(KeyError):
        udf_j.fn({"tokens": toks})
    with pytest.raises((KeyError, AttributeError)):
        udf_t.fn({"tokens": toks})


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
GPU_CASES = {
    # name -> (config, dtype, batch, seq, launches a forward by kernel)
    "mamba-reduced": (lambda: reduced("mamba2-370m"), "float32", 2, 64,
                      {"ssd": 2}),
    "mamba-full-widths-2-layers": (MODELS["mamba-full-widths-2-layers"],
                                   "bfloat16", 2, 128, {"ssd": 2}),
    "rgemma-heads": (MODELS["rgemma-heads"], "float32", 2, 40,
                     {"rglru": 3, "flash_attention": 1}),
    "rgemma-full-widths-3-layers": (lambda: dataclasses.replace(
        configs.get_config("recurrentgemma-9b"), num_layers=3), "bfloat16",
        1, 300, {"rglru": 2, "flash_attention": 1}),
    "whisper-reduced": (MODELS["whisper-reduced"], "float32", 2, 24,
                        {"flash_attention": 6}),
    "whisper-full-widths-2-layers": (lambda: dataclasses.replace(
        configs.get_config("whisper-small"), num_layers=2,
        num_encoder_layers=2), "bfloat16", 2, 64, {"flash_attention": 6}),
}
COUNTERS = {"ssd": ssd, "rglru": rglru, "flash_attention": flash_attention}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GPU_CASES))
def test_forward_through_the_kernels_on_card(card, monkeypatch, name):
    """The forward on the card launches each kernel as often as the
    family's blocks call it and agrees with the same forward through the
    kernels' plain versions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    make, dtype, b, s, launches = GPU_CASES[name]
    cfg = dataclasses.replace(make(), dtype=dtype)
    api = model_api(cfg)
    model = api.init_params(cfg, torch.Generator(card).manual_seed(0),
                            device=card)
    batch = {"tokens": torch.from_numpy(_tokens(b, s, cfg.vocab_size)).to(card)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(_frames(cfg, b)).to(card)
    before = {k: c.launches for k, c in COUNTERS.items()}
    with torch.inference_mode():
        got = api.forward(cfg, model, batch)
        torch.cuda.synchronize()
        counted = {k: c.launches - before[k] for k, c in COUNTERS.items()}
        monkeypatch.setattr(ssm, "ssd_bshp", ref.ssd)
        monkeypatch.setattr(hybrid, "rglru_bsw", ref.rglru)
        monkeypatch.setattr(attention, "flash_attention_bshd",
                            ref.flash_attention_bshd)
        want = api.forward(cfg, model, batch)
    assert {k: v for k, v in counted.items() if v} == launches
    assert bool(torch.isfinite(got).all())
    _close(got, want, TOL_TIGHT if dtype == "float32" else TOL_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mamba-reduced", "rgemma-heads",
                                  "whisper-reduced"])
def test_decode_on_card_matches_the_cpu(card, name):
    """Prefill and two decode steps on the card against the same on the
    CPU (the reduced configs in float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MODELS[name]()
    api = model_api(cfg)
    model = api.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(_tokens(2, 42, cfg.vocab_size, seed=2))
    batch = {"tokens": toks[:, :40]}
    kw = {}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(_frames(cfg, 2))
        kw["pad_cache_to"] = 42
    on_card = {k: v.to(card) for k, v in batch.items()}
    model_card = api.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu").to(card)
    with torch.inference_mode():
        cache_c, logits_c = api.prefill(cfg, model, batch, **kw)
        cache_g, logits_g = api.prefill(cfg, model_card, on_card, **kw)
        _close(logits_g, logits_c)
        for t in (40, 41):
            cache_c, logits_c = api.decode_step(cfg, model, cache_c,
                                                {"token": toks[:, t]})
            cache_g, logits_g = api.decode_step(
                cfg, model_card, cache_g, {"token": toks[:, t].to(card)})
            _close(logits_g, logits_c)
