"""Training the moe family, and the router's gradient, in the port against
the JAX package.

The same numpy draws go through ``repro`` (the reference: its plain router
``kref.moe_topk_router`` and its attention on the XLA path, differentiated
by JAX) and ``repro_torch`` on the CPU, where the router wrapper's
gradient is ``ref.moe_router_bwd`` and the flash wrapper's
``ref.flash_attention_bwd``:

* ``ref.moe_router_bwd`` (the closed form) against ``jax.grad`` of
  ``repro.kernels.ref.moe_topk_router`` at (T, E, k) = (512, 128, 2) with
  tied rows, grok's (1024, 8, 2) and arctic's (1024, 128, 2): within
  ``TOL_TIGHT``, and exactly 0 at every expert a row did not choose; the
  autograd function ``kernels.moe_router.RouterTopK`` on the CPU against
  torch's autograd through ``ref.moe_topk_router``;
* ``loss_fn``'s loss, task loss and aux loss and every leaf's gradient
  against ``jax.value_and_grad`` of the reference's ``loss_fn`` on the
  JAX package's own parameters (``convert.model_params``), grok-1-314b and
  arctic-480b reduced (arctic keeps its dense residual MLP);
* three ``make_train_step`` steps under AdamW from the state after one
  JAX step (``convert.optimizer_state``), against the JAX package's
  jitted step; remat on against off, the router run again in the backward
  pass; ``build`` for both, reduced and at full width.

The tolerance is ``TOL_TIGHT``. Tests marked ``gpu`` run the router
gradient kernel (``csrc/moe_router.cu``'s ``moe_router_bwd``) against its
plain version and grok's reduced train step through the kernels, and skip
without a card. JAX is imported inside fixtures.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention, moe_router, ref
from repro_torch.launch import train as port_train
from repro_torch.models import attention, moe
from repro_torch.models.params import get_param, param_leaves, stacked
from repro_torch.models.registry import model_api
from repro_torch.optim import AdamW, cosine_schedule

torch.set_num_threads(1)

TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-3   # float32 gradients on the card, kernels against plain
GRAD_ATOL = 1e-3   # ... and this times the leaf's largest (3xTF32 flash)


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


# --------------------------------------------------------------------------- #
# the router's gradient                                                       #
# --------------------------------------------------------------------------- #
def router_draws(t: int, e: int, seed: int, tied: bool):
    """(logits (T, E), the weights' cotangent (T, 2)); with ``tied``, a
    third of the rows draw their logits from four values, so the top two
    tie often and the lowest index must win."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, e)).astype(np.float32) * 1.6
    if tied:
        rows = rng.random(t) < 1 / 3
        logits[rows] = rng.choice(np.float32([-1.0, 0.25, 0.5, 2.0]),
                                  (int(rows.sum()), e))
    dw = rng.standard_normal((t, 2)).astype(np.float32)
    return logits, dw


# (T, E, k, tied): the PR-20 check's shape, grok's and arctic's
ROUTER_CASES = [(512, 128, 2, True), (1024, 8, 2, False),
                (1024, 128, 2, False), (1024, 8, 2, True)]


@pytest.mark.parametrize("t,e,k,tied", ROUTER_CASES)
def test_router_bwd_matches_jax(jx, t, e, k, tied):
    logits, dw = router_draws(t, e, seed=t + e, tied=tied)
    want = np.asarray(jx.jax.grad(lambda x: jx.jnp.sum(
        jx.ref.moe_topk_router(x, k)[0] * dw))(jx.jnp.asarray(logits)))
    w, idx = ref.moe_topk_router(torch.from_numpy(logits), k)
    got = ref.moe_router_bwd(w, idx, torch.from_numpy(dw), e)
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, e)
    np.testing.assert_allclose(got.numpy(), want, **TOL_TIGHT)
    chosen = np.zeros((t, e), bool)
    np.put_along_axis(chosen, idx.numpy().astype(np.int64), True, 1)
    assert (got.numpy()[~chosen] == 0).all()
    # each row's gradient sums to 0 over its chosen experts (a softmax's)
    np.testing.assert_allclose(got.sum(1).numpy(), 0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_router_autograd_matches_torch_autograd(dtype):
    logits, dw = router_draws(300, 16, seed=7, tied=True)
    x = torch.from_numpy(logits).to(dtype)
    before = (moe_router.launches, moe_router.backward_launches)
    leaf = x.clone().requires_grad_()
    w, idx = moe_router.moe_router_tk(leaf, 2)
    assert w.requires_grad and not idx.requires_grad
    (got,) = torch.autograd.grad(w, leaf, torch.from_numpy(dw).to(dtype))
    leaf2 = x.clone().requires_grad_()
    w2, idx2 = ref.moe_topk_router(leaf2, 2)
    (want,) = torch.autograd.grad(w2, leaf2, torch.from_numpy(dw).to(dtype))
    assert idx.equal(idx2) and got.dtype == dtype
    tol = TOL_TIGHT if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    # the CPU runs the plain versions: nothing is launched
    assert (moe_router.launches, moe_router.backward_launches) == before


def test_token_entry_still_refuses_a_gradient():
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(1, 16, (2, 6)).astype(np.int32))
    emb = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    gate = torch.from_numpy(rng.standard_normal((4, 8)).astype(
        np.float32)).requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward yet"):
        moe_router.moe_router_tokens(toks, emb, gate, 2)


# --------------------------------------------------------------------------- #
# loss_fn and its gradients, train steps                                      #
# --------------------------------------------------------------------------- #
def _cfgs(jx, arch, **kw):
    jc = jx.configs.get_config(arch).reduce_for_smoke()
    pc = get_config(arch).reduce_for_smoke()
    return dataclasses.replace(jc, **kw), dataclasses.replace(pc, **kw)


def _np_tree(jx, tree):
    return jx.jax.tree.map(np.asarray, tree)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _port_batch(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _jax_batch(jx, batch):
    return {k: jx.jnp.asarray(v) for k, v in batch.items()}


def _grads(cfg, model, batch):
    """(loss, metrics, {name: gradient stacked over the layers})."""
    api = model_api(cfg)
    shapes = api.param_shapes(cfg)
    names = [name for name, _ in param_leaves(shapes)]
    values = [get_param(model, n) for n in names]
    flat = [t for v in values for t in (v if isinstance(v, list) else [v])]
    model.requires_grad_(True)
    try:
        loss, metrics = api.loss_fn(cfg, model, batch)
        gs = iter(torch.autograd.grad(loss, flat))
    finally:
        model.requires_grad_(False)
    out = {}
    for name, v in zip(names, values):
        out[name] = (torch.stack([next(gs) for _ in v])
                     if isinstance(v, list) else next(gs))
    return float(loss.detach()), metrics, out


def _assert_tree_close(port: dict, jax_tree, what=""):
    want = dict(param_leaves(jax_tree))
    assert list(port) == list(want), what
    for name, value in port.items():
        assert tuple(value.shape) == tuple(np.shape(want[name])), name
        np.testing.assert_allclose(value.float().cpu().numpy(),
                                   np.asarray(want[name], np.float32),
                                   **TOL_TIGHT, err_msg=f"{what} {name}")


ARCHS = ["grok-1-314b", "arctic-480b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(jx, arch):
    jcfg, pcfg = _cfgs(jx, arch)
    japi = jx.model_api(jcfg)
    jparams = japi.init_params(jcfg, jx.jax.random.key(3))
    batch = _batch(pcfg, 2, 24, seed=5)
    (jloss, jm), jgrads = jx.jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, _jax_batch(jx, batch)),
        has_aux=True)(jparams)
    model = convert.model_params(_np_tree(jx, jparams), pcfg, device="cpu")
    loss, metrics, grads = _grads(pcfg, model, _port_batch(batch))
    np.testing.assert_allclose(loss, float(jloss), **TOL_TIGHT)
    assert set(metrics) == {"loss", "aux_loss"}
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key].detach()), float(jm[key]),
                                   **TOL_TIGHT, err_msg=key)
    _assert_tree_close(grads, _np_tree(jx, jgrads), what=arch)
    assert float(grads["layers.router"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(jx, arch):
    b, s = 2, 16
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
        for k in pm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       **TOL_TIGHT, err_msg=k)
    _assert_tree_close(stacked(model, model_api(pcfg).param_shapes(pcfg)),
                       _np_tree(jx, jparams), what="params")
    want = _np_tree(jx, jstate)
    for key in ("m", "v"):
        _assert_tree_close(state[key], want[key], what=key)
    assert not any(p.requires_grad for p in model.parameters())


def test_remat_reruns_the_router_and_keeps_the_gradients(jx, monkeypatch):
    jcfg, pcfg = _cfgs(jx, "grok-1-314b")
    params = _np_tree(jx, jx.model_api(jcfg).init_params(
        jcfg, jx.jax.random.key(2)))
    batch = _port_batch(_batch(pcfg, 2, 24, seed=9))
    base = _grads(pcfg, convert.model_params(params, pcfg, "cpu"), batch)
    calls = {"router": [], "router_bwd": []}
    for name, key in (("moe_topk_router", "router"),
                      ("moe_router_bwd", "router_bwd")):
        plain = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _p=plain, _k=key, **kw: (
            calls[_k].append(1), _p(*a, **kw))[1])
    rcfg = dataclasses.replace(pcfg, remat=True)
    got = _grads(rcfg, convert.model_params(params, rcfg, "cpu"), batch)
    layers = pcfg.num_layers
    assert {k: len(v) for k, v in calls.items()} == {
        "router": 2 * layers, "router_bwd": layers}
    np.testing.assert_allclose(got[0], base[0], **TOL_TIGHT)
    for name in base[2]:
        torch.testing.assert_close(got[2][name], base[2][name], **TOL_TIGHT)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_returns_a_moe_train_step(arch, reduced):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduce_for_smoke()
    api, opt, step = port_train.build(cfg)
    assert api is moe and isinstance(opt, AdamW) and callable(step)


def test_train_loop_trains_grok_reduced():
    cfg = get_config("grok-1-314b").reduce_for_smoke()
    out = port_train.train_loop(cfg, steps=3, batch=2, seq=16, device="cpu")
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("t,e,k,tied", ROUTER_CASES)
def test_router_bwd_kernel_matches_its_plain_version_on_card(card, t, e, k,
                                                            tied):
    """Bit-equal to ``ref.moe_router_bwd`` on the card (the same products
    and order, no contraction), exactly 0 at the experts not chosen, and
    the same bits on a rerun."""
    logits, dw = router_draws(t, e, seed=t + e, tied=tied)
    w, idx = moe_router.moe_router_tk(torch.from_numpy(logits).to(card), k)
    dwt = torch.from_numpy(dw).to(card)
    before = moe_router.backward_launches
    got = moe_router.moe_router_bwd(w, idx, dwt, e)
    again = moe_router.moe_router_bwd(w, idx, dwt, e)
    want = ref.moe_router_bwd(w, idx, dwt, e)
    torch.cuda.synchronize()
    assert moe_router.backward_launches - before == 2
    assert got.equal(again)
    torch.testing.assert_close(got, want, **TOL_TIGHT)
    chosen = torch.zeros((t, e), dtype=torch.bool, device=card).scatter_(
        1, idx.long(), True)
    assert bool((got[~chosen] == 0).all())


@pytest.mark.gpu
def test_grok_train_step_through_the_kernels_on_card(card, monkeypatch):
    """grok-1 reduced (2 layers), float32, remat: one train step launches
    the router forward 4 times (forward and recompute), its gradient twice
    and the flash kernel and its gradient as many times, and its gradients
    agree with the same step through the plain versions to GRAD_RTOL and
    GRAD_ATOL times each leaf's largest."""
    cfg = dataclasses.replace(get_config("grok-1-314b").reduce_for_smoke(),
                              remat=True)
    model = moe.init_params(cfg, torch.Generator(card).manual_seed(0),
                            device=card)
    batch = _port_batch(_batch(cfg, 2, 128, seed=3), card)
    counts = (moe_router.launches, moe_router.backward_launches,
              flash_attention.launches, flash_attention.backward_launches)
    loss, _, got = _grads(cfg, model, batch)
    torch.cuda.synchronize()
    now = (moe_router.launches, moe_router.backward_launches,
           flash_attention.launches, flash_attention.backward_launches)
    layers = cfg.num_layers
    assert tuple(b - a for a, b in zip(counts, now)) == (
        2 * layers, layers, 2 * layers, layers)
    monkeypatch.setattr(moe, "moe_router_tk", ref.moe_topk_router)
    monkeypatch.setattr(attention, "flash_attention_bshd",
                        ref.flash_attention_bshd)
    want_loss, _, want = _grads(cfg, model, batch)
    np.testing.assert_allclose(loss, want_loss, rtol=GRAD_RTOL)
    for name, g in got.items():
        scale = float(want[name].abs().max())
        torch.testing.assert_close(g, want[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * max(scale, 1e-12),
                                   msg=name)
