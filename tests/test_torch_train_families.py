"""Training the encdec and hybrid families, and the RG-LRU gradient, in the
port against the JAX package.

The same numpy draws go through ``repro`` (the reference: its attention
and its RG-LRU on the XLA path, differentiated by JAX) and ``repro_torch``
on the CPU, where the flash wrapper's gradient is
``ref.flash_attention_bwd`` and the RG-LRU wrapper's ``ref.rglru_bwd``:

* ``loss_fn``'s value and every leaf's gradient against
  ``jax.value_and_grad`` of the reference's, on the JAX package's own
  parameters (``convert.model_params``): whisper-small reduced (its
  frames included), recurrentgemma-9b reduced at a length past its window
  of 32, and recurrentgemma-9b reduced with its published head width of
  256 (a layer stack of no remainder layers in both);
* three ``make_train_step`` steps under AdamW from the state after one
  JAX step (``convert.optimizer_state``), against the JAX package's
  jitted step; remat on against off, with every layer's kernels run
  again in the backward pass; ``build`` for both families, reduced and
  at full width, and ``train_loop`` on the hybrid;
* ``ref.rglru_bwd`` (the closed form) against ``jax.grad`` of
  ``repro.kernels.ref.rglru``, with and without h0 and a cotangent of the
  last state, with a channel where the clamp of 1 - a^2 binds; the
  autograd function ``kernels.rglru.Rglru`` on the CPU against torch's
  autograd through ``ref.rglru``, its gradients' dtypes and a cotangent
  autograd leaves out.

The tolerance is ``TOL_TIGHT`` unless a test states another. Tests marked
``gpu`` run the families' train steps and the RG-LRU gradient kernel
(``csrc/rglru_bwd.cu``) on the card, and skip without one. JAX is
imported inside fixtures.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed.fault_tolerance import FailureInjector
from repro_torch.kernels import flash_attention, ref, rglru
from repro_torch.launch import train as port_train
from repro_torch.models.params import get_param, param_leaves, stacked
from repro_torch.models.registry import model_api
from repro_torch.optim import AdamW, cosine_schedule

torch.set_num_threads(1)

TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-3   # float32 gradients on the card, kernels against plain
GRAD_ATOL = 1e-3   # ... and this times the leaf's largest (3xTF32)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro import configs as jax_configs
    from repro import optim as jax_optim
    from repro.kernels import ref as jax_ref
    from repro.models.registry import model_api as jax_model_api
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, configs=jax_configs,
                                 optim=jax_optim, ref=jax_ref,
                                 model_api=jax_model_api)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfgs(jx, arch, **kw):
    """(JAX config, port config): ``arch`` reduced, then ``kw``."""
    jc = jx.configs.get_config(arch).reduce_for_smoke()
    pc = get_config(arch).reduce_for_smoke()
    return dataclasses.replace(jc, **kw), dataclasses.replace(pc, **kw)


def _np_tree(jx, tree):
    return jx.jax.tree.map(np.asarray, tree)


def _batch(cfg, b, s, seed):
    """Tokens and labels, and an encdec model's frames, from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.num_frames, cfg.d_model)).astype(np.float32)
    return out


def _port_batch(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _jax_batch(jx, batch):
    return {k: jx.jnp.asarray(v) for k, v in batch.items()}


def _grads(cfg, model, batch):
    """(loss, {name: gradient stacked over the layers}) of the family's
    ``loss_fn``."""
    api = model_api(cfg)
    shapes = api.param_shapes(cfg)
    names = [name for name, _ in param_leaves(shapes)]
    values = [get_param(model, n) for n in names]
    flat = [t for v in values for t in (v if isinstance(v, list) else [v])]
    model.requires_grad_(True)
    try:
        loss, _ = api.loss_fn(cfg, model, batch)
        gs = iter(torch.autograd.grad(loss, flat))
    finally:
        model.requires_grad_(False)
    out = {}
    for (name, s), v in zip(param_leaves(shapes), values):
        if isinstance(v, list):
            out[name] = (torch.stack([next(gs) for _ in v]) if v else
                         torch.zeros(s.shape, dtype=s.dtype))
        else:
            out[name] = next(gs)
    return float(loss.detach()), out


def _assert_tree_close(port: dict, jax_tree, what=""):
    want = dict(param_leaves(jax_tree))
    assert list(port) == list(want), what
    for name, value in port.items():
        assert tuple(value.shape) == tuple(np.shape(want[name])), name
        np.testing.assert_allclose(value.float().cpu().numpy(),
                                   np.asarray(want[name], np.float32),
                                   **TOL_TIGHT, err_msg=f"{what} {name}")


# --------------------------------------------------------------------------- #
# loss_fn and its gradients                                                   #
# --------------------------------------------------------------------------- #
# name -> (arch, config changes, (B, S))
GRAD_CASES = {
    "whisper-small reduced, frames": ("whisper-small", {}, (2, 24)),
    "recurrentgemma-9b reduced, S 48 past window 32": (
        "recurrentgemma-9b", {}, (2, 48)),
    "recurrentgemma-9b reduced, head_dim 256": (
        "recurrentgemma-9b", {"head_dim": 256}, (2, 40)),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_loss_and_grads_match_jax(jx, case):
    arch, kw, (b, s) = GRAD_CASES[case]
    jcfg, pcfg = _cfgs(jx, arch, **kw)
    japi = jx.model_api(jcfg)
    jparams = japi.init_params(jcfg, jx.jax.random.key(3))
    batch = _batch(pcfg, b, s, seed=5)
    jloss, jgrads = jx.jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, _jax_batch(jx, batch))[0])(jparams)
    model = convert.model_params(_np_tree(jx, jparams), pcfg, device="cpu")
    loss, grads = _grads(pcfg, model, _port_batch(batch))
    np.testing.assert_allclose(loss, float(jloss), **TOL_TIGHT)
    _assert_tree_close(grads, _np_tree(jx, jgrads), what=case)


# --------------------------------------------------------------------------- #
# train steps                                                                 #
# --------------------------------------------------------------------------- #
STEP_CASES = {"whisper-small": (2, 16), "recurrentgemma-9b": (2, 40)}


@pytest.mark.parametrize("arch", sorted(STEP_CASES))
def test_three_train_steps_match_jax(jx, arch):
    b, s = STEP_CASES[arch]
    jcfg, pcfg = _cfgs(jx, arch)
    jopt = jx.optim.AdamW(schedule=jx.optim.cosine_schedule(3e-3, 2, 10),
                          weight_decay=0.1)
    popt = AdamW(schedule=cosine_schedule(3e-3, 2, 10), weight_decay=0.1)
    japi = jx.model_api(jcfg)
    jparams = japi.init_params(jcfg, jx.jax.random.key(1))
    jstate = jopt.init(jparams)
    jstep = jx.jax.jit(japi.make_train_step(jcfg, jopt))
    jparams, jstate, _ = jstep(jparams, jstate,
                               _jax_batch(jx, _batch(pcfg, b, s, seed=100)))
    model = convert.model_params(_np_tree(jx, jparams), pcfg, device="cpu")
    state = convert.optimizer_state(_np_tree(jx, jstate), pcfg, device="cpu")
    pstep = model_api(pcfg).make_train_step(pcfg, popt)
    for i in range(3):
        batch = _batch(pcfg, b, s, seed=101 + i)
        jparams, jstate, jm = jstep(jparams, jstate, _jax_batch(jx, batch))
        model, state, pm = pstep(model, state, _port_batch(batch))
        assert set(pm) == {"loss", "grad_norm"}
        for k in pm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       **TOL_TIGHT, err_msg=k)
    _assert_tree_close(stacked(model, model_api(pcfg).param_shapes(pcfg)),
                       _np_tree(jx, jparams), what="params")
    want = _np_tree(jx, jstate)
    np.testing.assert_array_equal(int(state["count"]), int(want["count"]))
    for key in ("m", "v"):
        _assert_tree_close(state[key], want[key], what=key)
    assert not any(p.requires_grad for p in model.parameters())


def _count_calls(monkeypatch, module, name):
    calls = []
    plain = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("arch,calls_a_pass", [
    ("whisper-small", {"flash": 6}),          # 2 encoder, 2 self, 2 cross
    ("recurrentgemma-9b", {"flash": 1, "rglru": 3}),   # 4 layers: a rest
])
def test_remat_reruns_each_layer_and_keeps_the_gradients(jx, arch,
                                                          calls_a_pass,
                                                          monkeypatch):
    kw = {"num_layers": 4} if arch == "recurrentgemma-9b" else {}
    jcfg, pcfg = _cfgs(jx, arch, **kw)
    params = _np_tree(jx, jx.model_api(jcfg).init_params(
        jcfg, jx.jax.random.key(2)))
    batch = _port_batch(_batch(pcfg, 2, 40, seed=9))
    base = _grads(pcfg, convert.model_params(params, pcfg, "cpu"), batch)
    calls = {"flash": _count_calls(monkeypatch, ref, "flash_attention_bshd"),
             "rglru": _count_calls(monkeypatch, ref, "rglru")}
    rcfg = dataclasses.replace(pcfg, remat=True)
    got = _grads(rcfg, convert.model_params(params, rcfg, "cpu"), batch)
    # the forward and, under remat, its recompute in the backward pass
    assert {k: len(v) for k, v in calls.items() if k in calls_a_pass} == {
        k: 2 * n for k, n in calls_a_pass.items()}
    np.testing.assert_allclose(got[0], base[0], **TOL_TIGHT)
    for name in base[1]:
        torch.testing.assert_close(got[1][name], base[1][name], **TOL_TIGHT)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ["whisper-small", "recurrentgemma-9b"])
def test_build_returns_a_train_step(arch, reduced):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduce_for_smoke()
    api, opt, step = port_train.build(cfg)
    assert api is model_api(cfg) and isinstance(opt, AdamW)
    assert callable(step)


def test_train_loop_trains_the_hybrid(tmp_path):
    cfg = get_config("recurrentgemma-9b").reduce_for_smoke()
    out = port_train.train_loop(cfg, steps=4, batch=2, seq=40, device="cpu",
                                ckpt_dir=str(tmp_path), ckpt_every=2)
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    again = port_train.train_loop(cfg, steps=6, batch=2, seq=40,
                                  device="cpu", ckpt_dir=str(tmp_path),
                                  ckpt_every=2)
    assert len(again["losses"]) == 2   # resumed from step 4


# --------------------------------------------------------------------------- #
# the RG-LRU gradient                                                         #
# --------------------------------------------------------------------------- #
def _rglru_draws(seed, b, s, w):
    """x, r, i, a_param (channel 1's clamp of 1 - a^2 binds: a = 1 in
    float32), h0 and the cotangents of out and of h_last."""
    rng = np.random.default_rng(seed)
    x, r, i = (rng.standard_normal((b, s, w)).astype(np.float32)
               for _ in range(3))
    a_param = rng.standard_normal(w).astype(np.float32)
    a_param[1] = -40.0
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    dout = rng.standard_normal((b, s, w)).astype(np.float32)
    dh_last = rng.standard_normal((b, w)).astype(np.float32)
    return x, r, i, a_param, h0, dout, dh_last


# (with h0, with a cotangent of h_last)
RGLRU_GRAD_CASES = [(True, True), (True, False), (False, True),
                    (False, False)]


def _jax_rglru_grads(jx, x, r, i, a_param, h0, dout, dh_last):
    jnp = jx.jnp

    def loss(x, r, i, a_param, *h):
        out, last = jx.ref.rglru(x, r, i, a_param, h[0] if h else None)
        extra = 0.0 if dh_last is None else jnp.sum(last * dh_last)
        return jnp.sum(out * dout) + extra

    args = (x, r, i, a_param) + (() if h0 is None else (h0,))
    return [np.asarray(g) for g in jx.jax.grad(
        loss, argnums=tuple(range(len(args))))(*args)]


@pytest.mark.parametrize("with_h0,with_dh_last", RGLRU_GRAD_CASES)
def test_rglru_bwd_matches_jax(jx, with_h0, with_dh_last):
    x, r, i, a_param, h0, dout, dh_last = _rglru_draws(3, 2, 96, 32)
    h0 = h0 if with_h0 else None
    dh_last = dh_last if with_dh_last else None
    want = _jax_rglru_grads(jx, x, r, i, a_param, h0, dout, dh_last)
    t = torch.from_numpy
    h0t = None if h0 is None else t(h0)
    hs, _ = ref.rglru(t(x), t(r), t(i), t(a_param), h0t)
    got = ref.rglru_bwd(t(x), t(r), t(i), t(a_param), h0t, hs, t(dout),
                        None if dh_last is None else t(dh_last))
    assert (got[4] is None) == (h0 is None)
    for name, g, w in zip(("dx", "dr", "di", "da_param", "dh0"), got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL_TIGHT, err_msg=name)


@pytest.mark.parametrize("with_h0,with_dh_last", RGLRU_GRAD_CASES)
def test_rglru_autograd_matches_torch_autograd(with_h0, with_dh_last):
    x, r, i, a_param, h0, dout, dh_last = (
        torch.from_numpy(a) for a in _rglru_draws(4, 3, 70, 24))
    h0 = h0 if with_h0 else None

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (x, r, i, a_param)]
        h = None if h0 is None else h0.clone().requires_grad_()
        out, last = fn(*leaves, h)
        outs, cots = [out], [dout]
        if with_dh_last:
            outs.append(last)
            cots.append(dh_last)
        wrt = leaves + ([] if h is None else [h])
        return torch.autograd.grad(outs, wrt, cots)

    before = (rglru.launches, rglru.backward_launches)
    got = run(rglru.rglru_bsw)
    want = run(ref.rglru)
    assert (rglru.launches, rglru.backward_launches) == before  # the CPU
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL_TIGHT)


def test_rglru_autograd_dtypes_and_a_missing_cotangent():
    x, r, i, a_param, h0, dout, _ = (
        torch.from_numpy(a) for a in _rglru_draws(5, 2, 20, 8))
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (x, r, i)]
    lam = a_param.clone().requires_grad_()       # float32 beside bf16
    h = h0.to(torch.bfloat16).requires_grad_()
    out, last = rglru.rglru_bsw(*leaves, lam, h)
    assert out.dtype == last.dtype == torch.bfloat16
    # out's bits are the serving path's
    with torch.no_grad():
        plain = rglru.rglru_bsw(*leaves, lam, h)
    assert torch.equal(out, plain[0]) and torch.equal(last, plain[1])
    grads = torch.autograd.grad(out, leaves + [lam, h],
                                dout.to(torch.bfloat16))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [
        torch.float32, torch.bfloat16]
    # h_last left out of the loss: a zero cotangent
    f32 = [t.detach().float() for t in (*leaves, lam, h)]
    hs, _ = ref.rglru(*f32)
    want = ref.rglru_bwd(*f32[:4], f32[4], hs,
                         dout.to(torch.bfloat16).float(), None)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w.to(g.dtype), rtol=0, atol=0)


@pytest.mark.parametrize("with_h0,with_dh_last", [(False, False),
                                                  (True, True)])
def test_rglru_bwd_keeps_bf16_inputs_bf16(with_h0, with_dh_last):
    """bf16 x, r, i and dout give bf16 dx, dr and di: the plain version's
    float32 values rounded once (what the card's bf16 instance writes),
    with da_param and dh0 in float32."""
    x, r, i, a_param, h0, dout, dh_last = (
        torch.from_numpy(a) for a in _rglru_draws(8, 2, 45, 12))
    a_param[1] = -40.0   # the clamp of 1 - a^2 binds on this channel
    h0 = h0 if with_h0 else None
    dh_last = dh_last if with_dh_last else None
    bf = [t.to(torch.bfloat16) for t in (x, r, i, dout)]
    hs, _ = ref.rglru(*(t.float() for t in bf[:3]), a_param, h0)
    got = rglru.rglru_bwd(*bf[:3], a_param, h0, hs, bf[3], dh_last)
    want = ref.rglru_bwd(*(t.float() for t in bf[:3]), a_param, h0, hs,
                         bf[3].float(), dh_last)
    assert [None if g is None else g.dtype for g in got] == (
        [torch.bfloat16] * 3 + [torch.float32]
        + [torch.float32 if with_h0 else None])
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert torch.equal(g, w.to(g.dtype))


@pytest.mark.parametrize("with_h0,with_dh_last", [(False, True),
                                                  (True, False)])
def test_rglru_autograd_bf16_grads_keep_dtype_and_values(with_h0,
                                                         with_dh_last):
    x, r, i, a_param, h0, dout, dh_last = (
        torch.from_numpy(a) for a in _rglru_draws(9, 3, 33, 10))
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (x, r, i)]
    lam = a_param.clone().requires_grad_()
    h = h0.to(torch.bfloat16).requires_grad_() if with_h0 else None
    out, last = rglru.rglru_bsw(*leaves, lam, h)
    cot = [dout.to(torch.bfloat16), dh_last.to(torch.bfloat16)]
    outs, cots = ([out, last], cot) if with_dh_last else ([out], cot[:1])
    wrt = leaves + [lam] + ([h] if with_h0 else [])
    grads = torch.autograd.grad(outs, wrt, cots)
    assert [g.dtype for g in grads] == [t.dtype for t in wrt]
    f32 = [t.detach().float() for t in (*leaves, lam)]
    h0f = h.detach().float() if with_h0 else None
    hs, _ = ref.rglru(*f32, h0f)
    want = ref.rglru_bwd(*f32, h0f, hs, cots[0].float(),
                         cots[1].float() if with_dh_last else None)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w.to(g.dtype), rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
# (B, S, W) ragged: W not a multiple of 4 or of the 32-channel tile, S
# not a multiple of the 32-step chunk
RGLRU_CARD_SHAPES = [(3, 77, 50), (1, 33, 4096), (2, 300, 131), (5, 1, 36)]


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0,with_dh_last", [(True, True),
                                                  (False, False)])
@pytest.mark.parametrize("shape", RGLRU_CARD_SHAPES)
def test_rglru_bwd_kernel_matches_plain(card, shape, with_h0, with_dh_last):
    x, r, i, a_param, h0, dout, dh_last = (
        torch.from_numpy(a).to(card) for a in _rglru_draws(6, *shape))
    h0 = h0 if with_h0 else None
    dh_last = dh_last if with_dh_last else None
    hs, _ = rglru.rglru_bsw(x, r, i, a_param, h0)
    before = rglru.backward_launches
    got = rglru.rglru_bwd(x, r, i, a_param, h0, hs, dout, dh_last)
    again = rglru.rglru_bwd(x, r, i, a_param, h0, hs, dout, dh_last)
    torch.cuda.synchronize()
    assert rglru.backward_launches == before + 2
    want = ref.rglru_bwd(x, r, i, a_param, h0, hs, dout, dh_last)
    for name, g, a, w in zip(("dx", "dr", "di", "da_param", "dh0"), got,
                             again, want):
        if w is None:
            assert g is None and a is None
            continue
        assert torch.equal(g, a), name   # no atomics: the same bits
        torch.testing.assert_close(g, w, **TOL_TIGHT, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0,with_dh_last", [(True, True),
                                                  (False, False)])
@pytest.mark.parametrize("shape", RGLRU_CARD_SHAPES + [(2, 256, 4096)])
def test_rglru_bwd_bf16_instance_is_the_f32_kernel_cast(card, shape,
                                                        with_h0,
                                                        with_dh_last):
    """The bf16 instance (bf16 x, r, i, dout in; bf16 dx, dr, di out) gives
    the float32 instance's results on the same values, dx, dr and di
    rounded to bf16, bit for bit; dL and dh0 equal; a clamped channel."""
    x, r, i, a_param, h0, dout, dh_last = (
        torch.from_numpy(a).to(card) for a in _rglru_draws(7, *shape))
    a_param[1 % shape[2]] = -40.0
    h0 = h0 if with_h0 else None
    dh_last = dh_last if with_dh_last else None
    bf = [t.to(torch.bfloat16) for t in (x, r, i, dout)]
    hs, _ = rglru.rglru_bsw(*(t.float() for t in bf[:3]), a_param, h0)
    before = rglru.backward_launches
    got = rglru.rglru_bwd(*bf[:3], a_param, h0, hs, bf[3], dh_last)
    want = rglru.rglru_bwd(*(t.float() for t in bf[:3]), a_param, h0, hs,
                           bf[3].float(), dh_last)
    torch.cuda.synchronize()
    assert rglru.backward_launches == before + 2
    for name, g, w in zip(("dx", "dr", "di", "da_param", "dh0"), got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == (torch.bfloat16 if name[1] in "xri"
                           else torch.float32), name
        assert torch.equal(g, w.to(g.dtype)), name


def _card_model(cfg, seed=0):
    api = model_api(cfg)
    return api.init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                           device="cuda")


# arch -> (config changes, (B, S), flash forward, flash backward, rglru
# forward, rglru backward) launches a step under remat; the dense family's
# train step is chip_smoke.py phase 12's
CARD_STEPS = {
    "smollm-135m": ({}, (2, 48), 4, 2, 0, 0),   # the dense family, 2 layers
    "whisper-small": ({"num_frames": 128}, (2, 48), 12, 6, 0, 0),
    "recurrentgemma-9b": ({"num_layers": 4, "num_heads": 16,
                           "num_kv_heads": 1, "head_dim": 256,
                           "local_window": 16}, (2, 40), 2, 1, 6, 3),
}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(CARD_STEPS))
def test_card_train_step_launches_and_matches_plain(card, arch, monkeypatch):
    kw, (b, s), ffwd, fbwd, rfwd, rbwd = CARD_STEPS[arch]
    cfg = dataclasses.replace(get_config(arch).reduce_for_smoke(),
                              remat=True, **kw)
    batch = _port_batch(_batch(cfg, b, s, seed=11), "cuda")
    api, opt, step = port_train.build(cfg)
    model = _card_model(cfg)
    state = opt.init(stacked(model, api.param_shapes(cfg)))
    counts = (flash_attention.launches, flash_attention.backward_launches,
              rglru.launches, rglru.backward_launches)
    step(model, state, batch)
    torch.cuda.synchronize()
    now = (flash_attention.launches, flash_attention.backward_launches,
           rglru.launches, rglru.backward_launches)
    assert tuple(n - c for n, c in zip(now, counts)) == (ffwd, fbwd, rfwd,
                                                         rbwd)

    def stepped():
        m = _card_model(cfg)
        step(m, opt.init(stacked(m, api.param_shapes(cfg))), batch)
        return stacked(m, api.param_shapes(cfg))

    # float32 gradients and a step through the kernels against the same
    # through the plain versions; a stepped parameter within 2 lr (AdamW's
    # first update is -lr g / (|g| + eps): a gradient near 0 may take
    # either sign)
    k_loss, k_grads = _grads(cfg, _card_model(cfg), batch)
    k_params = stepped()
    from repro_torch.models import attention, hybrid
    monkeypatch.setattr(attention, "flash_attention_bshd",
                        ref.flash_attention_bshd)
    monkeypatch.setattr(hybrid, "rglru_bsw", ref.rglru)
    p_loss, p_grads = _grads(cfg, _card_model(cfg), batch)
    p_params = stepped()
    np.testing.assert_allclose(k_loss, p_loss, rtol=1e-5)
    lr1 = float(opt.schedule(torch.tensor(1)))
    for name, w in p_grads.items():
        lim = GRAD_RTOL * w.abs() + GRAD_ATOL * w.abs().max()
        assert bool(((k_grads[name] - w).abs() <= lim).all()), name
        assert float((k_params[name] - p_params[name]).abs().max()
                     ) <= 2 * lr1, name


@pytest.mark.gpu
def test_card_dense_train_loop_gates(card, tmp_path):
    """chip_smoke.py phase 12's gates on the dense family, reduced, in
    bf16 with remat (so the flash gradient's wgmma instances): each step
    launches the flash forward twice a layer and its gradient once; the
    loss falls; a second run gives the same bits; a run crashed at step 7
    and resumed from its newest checkpoint (step 6) ends on the
    uninterrupted run's losses and parameters, bit for bit."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduce_for_smoke(),
                              dtype="bfloat16", remat=True)
    steps, b, s = 12, 4, 64
    kw = dict(steps=steps, batch=b, seq=s, device="cuda")
    counts = (flash_attention.launches, flash_attention.backward_launches)
    run = port_train.train_loop(cfg, **kw)
    assert (flash_attention.launches - counts[0],
            flash_attention.backward_launches - counts[1]) == (
        2 * cfg.num_layers * steps, cfg.num_layers * steps)
    losses = run["losses"]
    assert np.isfinite(losses).all() and np.mean(losses[-3:]) < losses[0]
    shapes = model_api(cfg).param_shapes(cfg)
    want = stacked(run["params"], shapes)

    def same_bits(out):
        got = stacked(out["params"], shapes)
        return list(got) == list(want) and all(
            torch.equal(got[n], want[n]) for n in want)

    again = port_train.train_loop(cfg, **kw)
    assert again["losses"] == losses and same_bits(again)
    with pytest.raises(RuntimeError, match="injected failure"):
        port_train.train_loop(cfg, **kw, ckpt_dir=str(tmp_path),
                              ckpt_every=3, injector=FailureInjector([7]))
    resumed = port_train.train_loop(cfg, **kw, ckpt_dir=str(tmp_path),
                                    ckpt_every=3)
    assert resumed["losses"] == losses[6:] and same_bits(resumed)
