"""The port's configs and dense decoder (``repro_torch.configs``,
``repro_torch.models``) against the JAX package's.

The same numpy inputs, made from a seed, and the same parameters, drawn by
the JAX package and carried over by ``convert.transformer_params``, go
through both packages in float32. Logits, caches and layer outputs are held
to ``TOL_TIGHT`` (tests/test_kernels.py), with the JAX model's attention on
its XLA path and on the Pallas flash kernel in interpret mode:

* the layers (``rms_norm``, ``rope``, ``swiglu_mlp``, ``lm_logits`` with a
  padded vocabulary);
* ``forward``, ``prefill`` and ``decode_step`` at SmolLM-135M reduced for
  smoke tests and at its full widths with 2 layers, and h2o-danube reduced
  (a sliding window, so a ring-buffer cache) with prompts longer and
  shorter than the window; the vlm forward with patches;
* ``param_count`` and the parameter shapes at full size for every config
  (analytic; the ssm, hybrid and encdec families' forwards are held in
  tests/test_torch_families.py, the moe family's in
  tests/test_torch_moe.py); the configs themselves; the registry's
  refusal of an unknown family and ``transformer_params``' refusals.

Tests marked ``gpu`` run the forward through the hand-written flash kernel
on the card and skip without one.
"""
import ast
import dataclasses
import os
import re
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.kernels import flash_attention
from repro_torch.models import layers, transformer as tf
from repro_torch.models.params import param_leaves
from repro_torch.models.registry import family_module, model_api

# small tensors: one intra-op thread, so these tests do not crowd the
# timing-sensitive executor tests running beside them
torch.set_num_threads(1)

TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)   # tests/test_kernels.py::TOL_TIGHT
TOL_BF16 = dict(rtol=8e-2, atol=8e-2)    # tests/test_kernels.py, bfloat16
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
IMPLS = ("xla", "pallas")   # the JAX model's attention: XLA or Pallas (interpret)
PORTED = sorted(configs.ARCHS)


def smollm_full_2_layers(arch="smollm-135m"):
    """SmolLM-135M at its published widths, cut to 2 layers, in float32."""
    return dataclasses.replace(configs.get_config(arch), num_layers=2,
                               dtype="float32")


def reduced(arch):
    return configs.get_config(arch).reduce_for_smoke()


MODELS = {
    "smollm-reduced": lambda: reduced("smollm-135m"),
    "smollm-full-widths-2-layers": smollm_full_2_layers,
    "danube-reduced": lambda: reduced("h2o-danube-1.8b"),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules the tests compare against (imported here,
    so that the ``gpu`` tests also run on a card host without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jax_configs
    from repro.models import layers as jax_layers
    from repro.models import transformer as jax_tf
    from repro.models.registry import model_api as jax_model_api

    def cfg(port_cfg, **changes):
        """The JAX package's config of the same values."""
        return jax_configs.base.ModelConfig(
            **{**dataclasses.asdict(port_cfg), **changes})

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jax_configs,
                                 layers=jax_layers, tf=jax_tf,
                                 model_api=jax_model_api, cfg=cfg)


@pytest.fixture(scope="module")
def models(jx):
    """(JAX params, the port's Transformer) per model name, drawn once by
    the JAX package."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = MODELS[name]()
            params = jx.tf.init_params(jx.cfg(cfg), jx.jax.random.key(0))
            cache[name] = (params, convert.transformer_params(
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


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL_TIGHT):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# --------------------------------------------------------------------------- #
# configs and the registry                                                    #
# --------------------------------------------------------------------------- #
CONFIG_FILES = sorted(f for f in os.listdir(os.path.join(SRC, "repro",
                                                         "configs"))
                      if f.endswith(".py"))


def _statements(text: str) -> list:
    body = ast.parse(text).body
    if body and isinstance(body[0], ast.Expr) and isinstance(
            body[0].value, ast.Constant):
        body = body[1:]   # the module docstring
    return [ast.dump(n) for n in body]


@pytest.mark.parametrize("module", CONFIG_FILES)
def test_config_module_is_the_reference_with_imports_rewritten(module):
    ref = open(os.path.join(SRC, "repro", "configs", module)).read()
    port = open(os.path.join(SRC, "repro_torch", "configs", module)).read()
    rewritten = re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.",
                       ref, flags=re.M)
    assert _statements(port) == _statements(rewritten)


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_configs_equal_the_reference(jx, arch):
    want = jx.configs.get_config(arch)
    got = configs.get_config(arch)
    assert sorted(configs.ARCHS) == sorted(jx.configs.ARCHS)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduce_for_smoke()) == dataclasses.asdict(
        want.reduce_for_smoke())
    assert got.vocab_padded == want.vocab_padded


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_matches_the_reference_at_full_size(jx, arch):
    want = jx.configs.get_config(arch)
    got = configs.get_config(arch)
    api = model_api(got)
    assert api.param_count(got) == jx.model_api(want).param_count(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    shapes = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
              for k, v in param_leaves(api.param_shapes(got))}
    want_shapes = {k: (v.shape, str(v.dtype)) for k, v in param_leaves(
        jx.model_api(want).param_shapes(want))}
    assert shapes == want_shapes


def test_registry_raises_for_an_unknown_family():
    with pytest.raises(KeyError, match="rnn"):
        family_module("rnn")
    cfg = dataclasses.replace(reduced("smollm-135m"), family="rnn")
    with pytest.raises(KeyError):
        model_api(cfg)
    with pytest.raises(KeyError):
        convert.model_params({}, cfg, device="cpu")


def test_transformer_params_refuses_missing_extra_and_misshapen_leaves(
        jx, models):
    cfg = reduced("smollm-135m")
    params = jx.jax.tree.map(np.asarray, models("smollm-reduced")[0])
    missing = {k: v for k, v in params.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing.*final_norm"):
        convert.transformer_params(missing, cfg, device="cpu")
    extra = {**params, "out_head": np.zeros((64, 512), np.float32)}
    with pytest.raises(ValueError, match="extra.*out_head"):
        convert.transformer_params(extra, cfg, device="cpu")
    layers_ = dict(params["layers"], wq=params["layers"]["wq"][:, :, :2])
    with pytest.raises(ValueError, match="layers.wq"):
        convert.transformer_params({**params, "layers": layers_}, cfg,
                                   device="cpu")


def test_transformer_params_is_a_copy(models):
    cfg = reduced("smollm-135m")
    params, model = models("smollm-reduced")
    assert model.layers[1]["wq"].shape == (64, 4, 16)
    assert model.layers[0]["wo"].shape == (4, 16, 64)
    for name in tf.layer_param_shapes(cfg):
        stacked = torch.stack([lp[name] for lp in model.layers])
        np.testing.assert_array_equal(stacked.numpy(),
                                      np.asarray(params["layers"][name]))
    np.testing.assert_array_equal(model.embed.numpy(),
                                  np.asarray(params["embed"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_draws_as_the_reference(dtype):
    cfg = dataclasses.replace(reduced("smollm-135m"), dtype=dtype)
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    again = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    other = tf.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert all(p.dtype == getattr(torch, dtype) for p in model.parameters())
    assert not model.final_norm.any()   # 1-d: zero, as jnp.zeros
    for name, p in model.named_parameters():
        assert torch.equal(p, dict(again.named_parameters())[name])
        if p.dim() >= 2 or name.startswith("layers."):
            # stacked (L, d) norms are 2-d in the JAX layout: drawn too
            v = p.float()
            # within 2 std, after one rounding to the dtype (bf16: 2^-8)
            assert float(v.abs().max()) <= 0.04 * (1 + 2 ** -8)
            assert 0.01 < float(v.std()) < 0.02
            assert not torch.equal(p, dict(other.named_parameters())[name])


# --------------------------------------------------------------------------- #
# layers                                                                      #
# --------------------------------------------------------------------------- #
def _layer_case(jx, name, rng):
    jl, j = jx.layers, jx.jnp.asarray
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    h = rng.standard_normal((2, 8, 32)).astype(np.float32)
    if name == "rms_norm":
        w = rng.standard_normal(32).astype(np.float32) * 0.1
        return (jl.rms_norm(j(h), j(w), 1e-6),
                layers.rms_norm(torch.from_numpy(h), torch.from_numpy(w), 1e-6))
    if name == "rope":
        pos = np.tile(np.arange(3, 11, dtype=np.int32), (2, 1))
        return (jl.rope(j(x), j(pos), 10_000.0),
                layers.rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10_000.0))
    if name == "swiglu_mlp":
        ws = [rng.standard_normal(s).astype(np.float32) * 0.2
              for s in ((32, 48), (32, 48), (48, 32))]
        return (jl.swiglu_mlp(j(h), *map(j, ws), jl.NULL_CTX),
                layers.swiglu_mlp(torch.from_numpy(h),
                                  *map(torch.from_numpy, ws)))
    head = rng.standard_normal((32, 512)).astype(np.float32)  # 257 padded
    return (jl.lm_logits(j(h), j(head), 257, jl.NULL_CTX),
            layers.lm_logits(torch.from_numpy(h), torch.from_numpy(head), 257))


@pytest.mark.parametrize("name", ["rms_norm", "rope", "swiglu_mlp",
                                  "lm_logits"])
def test_layers_match_the_reference(jx, name):
    want, got = _layer_case(jx, name, np.random.default_rng(3))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    _close(got, want)
    if name == "lm_logits":
        assert (got[..., 257:] == -1e9).all()


def test_softmax_xent_matches_the_reference(jx):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 8, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 8)).astype(np.int32)
    mask = (rng.random((2, 8)) < 0.7).astype(np.float32)
    for m in (None, mask):
        want = jx.layers.softmax_xent(
            jx.jnp.asarray(logits), jx.jnp.asarray(labels),
            None if m is None else jx.jnp.asarray(m))
        got = layers.softmax_xent(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        _close(got, want)


# --------------------------------------------------------------------------- #
# forward, prefill and decode                                                 #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("config", ["smollm-reduced",
                                    "smollm-full-widths-2-layers"])
def test_forward_matches_the_reference(jx, models, config, impl):
    cfg = MODELS[config]()
    params, model = models(config)
    toks = _tokens(2, 64, cfg.vocab_size)
    want = jx.tf.forward(jx.cfg(cfg, attention_impl=impl), params,
                         {"tokens": jx.jnp.asarray(toks)})
    got = tf.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == want.shape == (2, 64, cfg.vocab_padded)
    _close(got, want)
    assert model.forward({"tokens": torch.from_numpy(toks)}).equal(got)


# (model, prompt length, decode steps); h2o-danube reduced has a window of
# 32: a prompt of 40 fills and wraps its ring, one of 20 leaves it short
DECODE_CASES = {
    "smollm-reduced": ("smollm-reduced", 24, 3),
    "smollm-full-widths-2-layers": ("smollm-full-widths-2-layers", 16, 2),
    "danube-reduced-wrapped": ("danube-reduced", 40, 3),
    "danube-reduced-short": ("danube-reduced", 20, 2),
}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_prefill_and_decode_match_the_reference(jx, models, case, impl):
    name, prompt, steps = DECODE_CASES[case]
    cfg = MODELS[name]()
    jcfg = jx.cfg(cfg, attention_impl=impl)
    params, model = models(name)
    toks = _tokens(2, prompt + steps, cfg.vocab_size, seed=1)
    pad = prompt + steps
    cache_j, logits_j = jx.tf.prefill(
        jcfg, params, {"tokens": jx.jnp.asarray(toks[:, :prompt])},
        pad_cache_to=pad)
    cache_t, logits_t = tf.prefill(
        cfg, model, {"tokens": torch.from_numpy(toks[:, :prompt])},
        pad_cache_to=pad)
    _close(logits_t, logits_j)
    assert tuple(cache_t["k"].shape) == cache_j["k"].shape
    for step in range(steps):
        tok = toks[:, prompt + step]
        cache_j, logits_j = jx.tf.decode_step(
            jcfg, params, cache_j, {"token": jx.jnp.asarray(tok)})
        cache_t, logits_t = tf.decode_step(
            cfg, model, cache_t, {"token": torch.from_numpy(tok)})
        _close(logits_t, logits_j)
    for key in ("k", "v"):
        _close(cache_t[key], cache_j[key])
    np.testing.assert_array_equal(cache_t["lengths"].numpy(),
                                  np.asarray(cache_j["lengths"]))


def test_vlm_forward_with_patches_matches_the_reference(jx):
    cfg = reduced("llava-next-34b")
    params = jx.tf.init_params(jx.cfg(cfg), jx.jax.random.key(2))
    model = convert.transformer_params(jx.jax.tree.map(np.asarray, params),
                                       cfg, device="cpu")
    rng = np.random.default_rng(5)
    toks = _tokens(2, 24, cfg.vocab_size, seed=5)
    patches = rng.standard_normal((2, cfg.num_patches, 1024)).astype(
        np.float32)
    want = jx.tf.forward(jx.cfg(cfg), params, {
        "tokens": jx.jnp.asarray(toks), "patches": jx.jnp.asarray(patches)})
    got = tf.forward(cfg, model, {
        "tokens": torch.from_numpy(toks), "patches": torch.from_numpy(patches)})
    assert tuple(got.shape) == want.shape == (2, 24 + cfg.num_patches,
                                              cfg.vocab_padded)
    _close(got, want)


@pytest.mark.parametrize("arch", ["smollm-135m", "h2o-danube-1.8b"])
def test_cache_shapes_match_the_reference(jx, arch):
    want, _ = jx.tf.cache_shapes(jx.configs.get_config(arch), 4, 8192)
    got = tf.cache_shapes(configs.get_config(arch), 4, 8192)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in want.items()}


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_through_the_flash_kernel_on_card(card, dtype):
    """SmolLM's full widths at 2 layers: the forward launches the kernel
    once a layer and agrees with the same forward on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(smollm_full_2_layers(), dtype=dtype)
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(3, 128, cfg.vocab_size))
    want = tf.forward(cfg, model, {"tokens": toks})
    before = flash_attention.launches
    got = tf.forward(cfg, model.to(card), {"tokens": toks.to(card)})
    torch.cuda.synchronize()
    assert flash_attention.launches - before == cfg.num_layers
    _close(got, want, TOL_TIGHT if dtype == "float32" else TOL_BF16)
