"""The port's training path against the JAX package's.

The same numpy draws go through ``repro`` (the reference, its attention on
the XLA path) and ``repro_torch`` on the CPU, where the flash wrapper's
gradient is ``ref.flash_attention_bwd``:

* ``loss_fn``'s value and every leaf's gradient against
  ``jax.value_and_grad`` of the reference's, on the JAX package's own
  parameters (``convert.model_params``), the layer leaves stacked: reduced
  smollm-135m, SmolLM's full widths at 2 layers, reduced h2o-danube (a
  sliding window) and reduced llava-next (patches and a loss mask);
* three ``make_train_step`` steps from the same parameters and optimizer
  state (``convert.optimizer_state`` of a state after one JAX step) under
  AdamW (float32 and bfloat16 moments), Adafactor and
  ``Int8ErrorFeedback(AdamW)``: parameters, state, loss and grad norm
  against the JAX package's jitted step; ``grad_accum`` 4 against the
  reference's and against 1; remat off against "nothing", "dots" and
  "dots_no_batch";
* mirrors of tests/test_optim.py, tests/test_data.py (the pipeline),
  tests/test_checkpoint.py (plus a bit-exact bfloat16 roundtrip) and
  tests/test_fault_tolerance.py against the port, ``TokenSource``
  bit-equal to the reference's, the fault-tolerance module line for line;
* ``launch.train`` (``main``, ``--mesh``, the families that cannot train
  yet: ssm and moe; encdec and hybrid training is in
  tests/test_torch_train_families.py), ``examples.train_lm`` and UC4 (``examples.review_analytics``) with
  the JAX example's initial parameters: the tuned parameters against the
  JAX example's, and the query's rows against its whole-table oracle
  under every eddy policy.

The tolerance is ``TOL_TIGHT`` unless a test states another. JAX is
imported inside fixtures.
"""
import dataclasses
import importlib.util
import os
import random
import re
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import Prefetcher, TokenSource, shard_batch
from repro_torch.distributed.fault_tolerance import (
    FailureInjector, Heartbeat, StepWatchdog,
)
from repro_torch.kernels import ref
from repro_torch.launch import train as port_train
from repro_torch.models import transformer as tf
from repro_torch.models.params import get_param, param_leaves, stacked
from repro_torch.optim import (
    AdamW, Adafactor, Int8ErrorFeedback, constant_schedule, cosine_schedule,
)
from repro_torch.optim.compression import quantize_dequantize

torch.set_num_threads(1)

TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)
# bfloat16 moments: 1e-7 of float32 noise in m32 or v32 can flip a bf16
# rounding, one ulp (2^-8 relative) of a moment, which moves that step's
# update by at most 2^-8 of it (of m) or 2^-9 (of v, under the root); an
# update is at most ~lr, so three steps at the peak 3e-3 move a parameter
# by at most 3 * 2^-7 * 3e-3 = 7e-5, and a moment lies within 2 ulps
TOL_BF16_PARAMS = dict(rtol=1e-4, atol=7e-5)
TOL_BF16_MOMENTS = dict(rtol=2.0 ** -7, atol=1e-5)
# Int8ErrorFeedback: its quantizer is a step function, so a gradient
# within float32 noise of a rounding boundary comes out one quantum apart
# in the two packages. Such flips are rare: at most FLIP_SHARE of a leaf's
# elements may lie outside TOL_TIGHT, and a flipped parameter by no more
# than the steps' updates can move it (3 steps at most ~lr = 3e-3 each)
FLIP_SHARE = 1e-3
FLIP_PARAM_ATOL = 3 * 3e-3
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro import configs as jax_configs
    from repro import optim as jax_optim
    from repro.data import pipeline as jax_pipeline
    from repro.models import transformer as jax_tf
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, configs=jax_configs,
                                 optim=jax_optim, tf=jax_tf,
                                 pipeline=jax_pipeline)


def _cfgs(jx, arch, **kw):
    """(JAX config, port config): ``arch`` reduced, then ``kw``; "full"
    in kw takes the full widths instead of the reduced ones."""
    full = kw.pop("full", False)
    jc, pc = jx.configs.get_config(arch), get_config(arch)
    if not full:
        jc, pc = jc.reduce_for_smoke(), pc.reduce_for_smoke()
    return dataclasses.replace(jc, **kw), dataclasses.replace(pc, **kw)


def _np_tree(jx, tree):
    return jx.jax.tree.map(np.asarray, tree)


def _batch(cfg, b, s, seed, mask=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, tf.VISION_FEAT_DIM)).astype(np.float32)
    if mask:
        out["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_params(jx, jcfg, seed=0):
    return jx.tf.init_params(jcfg, jx.jax.random.key(seed))


def _port_grads(cfg, model, batch):
    """(loss, {name: stacked gradient}) of ``tf.loss_fn``."""
    model.requires_grad_(True)
    try:
        loss, _ = tf.loss_fn(cfg, model, batch)
        loss.backward()
        grads = {}
        for name, _ in param_leaves(tf.param_shapes(cfg)):
            value = get_param(model, name)
            grads[name] = (value.grad if isinstance(value, torch.Tensor)
                           else torch.stack([t.grad for t in value]))
    finally:
        model.requires_grad_(False)
        model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _assert_tree_close(port: dict, jax_tree, tol=TOL_TIGHT, what=""):
    want = dict(param_leaves(jax_tree))
    assert list(port) == list(want), what
    for name, value in port.items():
        np.testing.assert_allclose(value.float().numpy(),
                                   np.asarray(want[name], np.float32), **tol,
                                   err_msg=f"{what} {name}")


def _assert_close_but_flips(got, want, bound=None, what=""):
    """Within TOL_TIGHT but for at most FLIP_SHARE of the elements (the
    quantizer's flips), those within ``bound`` if one is given."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    off = diff > TOL_TIGHT["atol"] + TOL_TIGHT["rtol"] * np.abs(want)
    assert off.sum() <= FLIP_SHARE * off.size, (what, int(off.sum()))
    if bound is not None:
        assert diff.max() <= bound, (what, float(diff.max()))


# --------------------------------------------------------------------------- #
# loss_fn and its gradients                                                   #
# --------------------------------------------------------------------------- #
GRAD_CASES = {
    "smollm-135m reduced": ("smollm-135m", {}, (2, 32), False),
    "smollm-135m widths, 2 layers": (
        "smollm-135m", {"full": True, "num_layers": 2, "dtype": "float32",
                        "remat": False}, (2, 16), False),
    "h2o-danube reduced, window 32": ("h2o-danube-1.8b", {}, (2, 64), False),
    "llava-next reduced, patches and a loss mask": (
        "llava-next-34b", {}, (2, 24), True),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_loss_and_grads_match_jax(jx, case):
    arch, kw, (b, s), mask = GRAD_CASES[case]
    jcfg, pcfg = _cfgs(jx, arch, **kw)
    jparams = _jax_params(jx, jcfg, seed=3)
    batch = _batch(pcfg, b, s, seed=5, mask=mask)
    jloss, jgrads = jx.jax.value_and_grad(
        lambda p: jx.tf.loss_fn(jcfg, p, {k: jx.jnp.asarray(v)
                                          for k, v in batch.items()})[0]
    )(jparams)
    model = convert.model_params(_np_tree(jx, jparams), pcfg, device="cpu")
    loss, grads = _port_grads(pcfg, model, _port_batch(batch))
    np.testing.assert_allclose(loss, float(jloss), **TOL_TIGHT)
    _assert_tree_close(grads, _np_tree(jx, jgrads), what=case)


def test_softmax_xent_grad_matches_jax(jx):
    from repro.models.layers import softmax_xent as jax_xent

    from repro_torch.models.layers import softmax_xent
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = np.asarray(jx.jax.grad(lambda x: jax_xent(
            x, labels, None if m is None else jx.jnp.asarray(m)))(
                jx.jnp.asarray(logits)))
        x = torch.from_numpy(logits).requires_grad_()
        softmax_xent(x, torch.from_numpy(labels),
                     None if m is None else torch.from_numpy(m)).backward()
        np.testing.assert_allclose(x.grad.numpy(), want, **TOL_TIGHT)


# --------------------------------------------------------------------------- #
# train steps                                                                 #
# --------------------------------------------------------------------------- #
def _optimizers(jx, name):
    """(JAX optimizer, port optimizer) of one kind, same hyperparameters."""
    kinds = {
        "adamw": lambda m, s: m.AdamW(schedule=s(3e-3, 2, 10),
                                      weight_decay=0.1),
        "adamw_bf16_moments": lambda m, s: m.AdamW(
            schedule=s(3e-3, 2, 10), moment_dtype="bfloat16"),
        "adafactor": lambda m, s: m.Adafactor(schedule=s(3e-3, 2, 10)),
        "int8_error_feedback": lambda m, s: m.Int8ErrorFeedback(
            m.AdamW(schedule=s(3e-3, 2, 10))),
    }
    port = types.SimpleNamespace(AdamW=AdamW, Adafactor=Adafactor,
                                 Int8ErrorFeedback=Int8ErrorFeedback)
    return (kinds[name](jx.optim, jx.optim.cosine_schedule),
            kinds[name](port, cosine_schedule))


def _state_leaves(state, prefix=""):
    """(dotted name, leaf) of an optimizer state (either package's, numpy
    or torch), the parameter names flattened as ``param_leaves`` does."""
    for key in sorted(state):
        value = state[key]
        if isinstance(value, dict):
            yield from _state_leaves(value, f"{prefix}{key}.")
        else:
            yield prefix + key, value


def _run_steps(jx, jcfg, pcfg, opt_name, steps=3, b=4, s=32):
    """Both packages' params, state and metrics after one JAX step (whose
    result the port takes over) and ``steps`` more in each."""
    jopt, popt = _optimizers(jx, opt_name)
    jparams = _jax_params(jx, jcfg, seed=1)
    jstate = jopt.init(jparams)
    jstep = jx.jax.jit(jx.tf.make_train_step(jcfg, jopt))
    first = _batch(pcfg, b, s, seed=100)
    jparams, jstate, _ = jstep(jparams, jstate, {
        k: jx.jnp.asarray(v) for k, v in first.items()})
    model = convert.model_params(_np_tree(jx, jparams), pcfg, device="cpu")
    state = convert.optimizer_state(_np_tree(jx, jstate), pcfg, device="cpu")
    pstep = tf.make_train_step(pcfg, popt)
    metrics = []
    for i in range(steps):
        batch = _batch(pcfg, b, s, seed=101 + i)
        jparams, jstate, jm = jstep(jparams, jstate, {
            k: jx.jnp.asarray(v) for k, v in batch.items()})
        model, state, pm = pstep(model, state, _port_batch(batch))
        metrics.append(({k: float(v) for k, v in jm.items()},
                        {k: float(v) for k, v in pm.items()}))
    return (jparams, jstate), (model, state), metrics


@pytest.mark.parametrize("opt_name", ["adamw", "adamw_bf16_moments",
                                      "adafactor", "int8_error_feedback"])
def test_three_train_steps_match_jax(jx, opt_name):
    jcfg, pcfg = _cfgs(jx, "smollm-135m")
    (jparams, jstate), (model, state), metrics = _run_steps(
        jx, jcfg, pcfg, opt_name)
    bf16 = opt_name == "adamw_bf16_moments"
    flips = opt_name == "int8_error_feedback"
    for jm, pm in metrics:
        assert set(pm) == {"loss", "grad_norm"}
        for k in pm:
            np.testing.assert_allclose(pm[k], jm[k], **TOL_TIGHT, err_msg=k)
    params = stacked(model, tf.param_shapes(pcfg))
    if flips:
        want = dict(param_leaves(_np_tree(jx, jparams)))
        for name, value in params.items():
            _assert_close_but_flips(value, want[name], FLIP_PARAM_ATOL, name)
    else:
        _assert_tree_close(params, _np_tree(jx, jparams),
                           TOL_BF16_PARAMS if bf16 else TOL_TIGHT,
                           what="params")
    want = dict(_state_leaves(_np_tree(jx, jstate)))
    got = dict(_state_leaves(state))
    assert sorted(got) == sorted(want)
    for name in got:
        g = got[name]
        assert str(g.dtype).replace("torch.", "") == str(want[name].dtype), name
        if flips:
            _assert_close_but_flips(g, want[name], what=name)
            continue
        tol = TOL_BF16_MOMENTS if g.dtype == torch.bfloat16 else TOL_TIGHT
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(want[name], np.float32),
                                   **tol, err_msg=name)


def test_vlm_train_steps_match_jax(jx):
    jcfg, pcfg = _cfgs(jx, "llava-next-34b")
    (jparams, _), (model, _), metrics = _run_steps(jx, jcfg, pcfg, "adamw",
                                                   steps=2, b=2, s=16)
    for jm, pm in metrics:
        for k in pm:
            np.testing.assert_allclose(pm[k], jm[k], **TOL_TIGHT, err_msg=k)
    _assert_tree_close(stacked(model, tf.param_shapes(pcfg)),
                       _np_tree(jx, jparams), what="params")


def test_grad_accum_matches_jax_and_one_batch(jx):
    jcfg, pcfg = _cfgs(jx, "smollm-135m", grad_accum=4)
    (jparams, _), (model, _), metrics = _run_steps(jx, jcfg, pcfg, "adamw",
                                                   steps=2, b=8, s=16)
    for jm, pm in metrics:
        for k in pm:
            np.testing.assert_allclose(pm[k], jm[k], **TOL_TIGHT, err_msg=k)
    _assert_tree_close(stacked(model, tf.param_shapes(pcfg)),
                       _np_tree(jx, jparams), what="params")
    # the same steps in one batch: the mean of equal microbatches' means
    _, pcfg1 = _cfgs(jx, "smollm-135m")
    _, (model1, _), metrics1 = _run_steps(jx, jcfg, pcfg1, "adamw", steps=2,
                                          b=8, s=16)
    for (_, pm), (_, pm1) in zip(metrics, metrics1):
        np.testing.assert_allclose(pm["loss"], pm1["loss"], **TOL_TIGHT)
    one = stacked(model1, tf.param_shapes(pcfg))
    for name, value in stacked(model, tf.param_shapes(pcfg)).items():
        torch.testing.assert_close(value, one[name], **TOL_TIGHT)


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_remat_policies_give_the_same_gradients(jx, policy, monkeypatch):
    jcfg, pcfg = _cfgs(jx, "smollm-135m")
    jparams = _np_tree(jx, _jax_params(jx, jcfg, seed=2))
    batch = _port_batch(_batch(pcfg, 2, 24, seed=9))
    base = _port_grads(pcfg, convert.model_params(jparams, pcfg, "cpu"),
                       batch)
    calls = []
    plain = ref.flash_attention_bshd

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(ref, "flash_attention_bshd", counted)
    rcfg = dataclasses.replace(pcfg, remat=True, remat_policy=policy)
    got = _port_grads(rcfg, convert.model_params(jparams, rcfg, "cpu"), batch)
    # every layer's attention ran again in the backward pass
    assert len(calls) == 2 * pcfg.num_layers
    np.testing.assert_allclose(got[0], base[0], **TOL_TIGHT)
    for name in base[1]:
        torch.testing.assert_close(got[1][name], base[1][name], **TOL_TIGHT)


def test_train_step_leaves_parameters_without_grad():
    cfg = get_config("smollm-135m").reduce_for_smoke()
    model = tf.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    opt = AdamW()
    state = opt.init(stacked(model, tf.param_shapes(cfg)))
    step = tf.make_train_step(cfg, opt)
    src = TokenSource(cfg.vocab_size, 16)
    model, state, m = step(model, state, shard_batch(src.next(2),
                                                     device="cpu"))
    assert int(state["count"]) == 1 and np.isfinite(float(m["loss"]))
    assert not any(p.requires_grad for p in model.parameters())


# --------------------------------------------------------------------------- #
# optimizers (tests/test_optim.py)                                            #
# --------------------------------------------------------------------------- #
def _optimize(opt, steps=200):
    target = torch.tensor([1.0, -2.0, 3.0])

    def loss(p):
        return torch.sum((p["w"] - target) ** 2) + torch.sum((p["b"] + 1.0) ** 2)

    params = {"w": torch.zeros(3), "b": torch.zeros(2)}
    state = opt.init(params)
    for _ in range(steps):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                 list(leaves.values()))))
        upd, state = opt.update(g, state, params)
        params = {k: params[k] + upd[k] for k in params}
    return float(loss(params))


def test_adamw_converges():
    assert _optimize(AdamW(schedule=constant_schedule(0.05))) < 1e-2


def test_adamw_bf16_moments_converge():
    opt = AdamW(schedule=constant_schedule(0.05), moment_dtype="bfloat16")
    assert _optimize(opt) < 5e-2


def test_adafactor_converges():
    assert _optimize(Adafactor(schedule=constant_schedule(0.1)), 300) < 5e-2


def test_int8_error_feedback_converges():
    opt = Int8ErrorFeedback(AdamW(schedule=constant_schedule(0.05)))
    assert _optimize(opt) < 5e-2


def test_adamw_matches_reference_math():
    """One AdamW step vs hand-computed update."""
    opt = AdamW(schedule=constant_schedule(0.1), b1=0.9, b2=0.99,
                eps=1e-8, clip_norm=0.0)
    p = {"w": torch.tensor([1.0])}
    g = {"w": torch.tensor([0.5])}
    upd, state = opt.update(g, opt.init(p), p)
    m = 0.1 * 0.5
    v = 0.01 * 0.25
    mhat = m / (1 - 0.9)
    vhat = v / (1 - 0.99)
    expect = -0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(float(upd["w"][0]), expect, rtol=1e-5)


def test_grad_clipping():
    opt = AdamW(schedule=constant_schedule(1.0), clip_norm=1.0)
    p = {"w": torch.tensor([0.0])}
    g = {"w": torch.tensor([1e6])}
    upd, _ = opt.update(g, opt.init(p), p)
    assert np.isfinite(float(upd["w"][0]))


def test_cosine_schedule_shape():
    s = cosine_schedule(1.0, warmup=10, total=100)
    assert float(s(0)) == 0.0
    assert abs(float(s(10)) - 1.0) < 1e-6
    assert float(s(55)) < 1.0
    assert float(s(100)) >= 0.1 - 1e-6  # floor


@pytest.mark.parametrize("opt_name", ["adamw", "adamw_bf16_moments",
                                      "adafactor", "int8_error_feedback"])
def test_optimizer_updates_match_jax(jx, opt_name):
    """Three updates of the same gradients and parameters, leaf shapes as
    a stacked model's (a 2-d norm stack is factored by Adafactor): the
    updates and the state against the reference's; the quantizer sees the
    same float32 inputs here, so Int8ErrorFeedback is held to TOL_TIGHT
    too."""
    jopt, popt = _optimizers(jx, opt_name)
    rng = np.random.default_rng(4)
    shapes = {"embed": (64, 16), "final_norm": (16,),
              "layers.attn_norm": (2, 16), "layers.wq": (2, 16, 4, 8)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.02
              for k, s in shapes.items()}
    jstate = jopt.init({k: jx.jnp.asarray(v) for k, v in params.items()})
    state = popt.init({k: torch.from_numpy(v) for k, v in params.items()})
    for i in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32) * 10.0 ** -i
                 for k, s in shapes.items()}
        jupd, jstate = jopt.update({k: jx.jnp.asarray(v) for k, v in grads.items()},
                                   jstate, {k: jx.jnp.asarray(v)
                                            for k, v in params.items()})
        upd, state = popt.update({k: torch.from_numpy(v) for k, v in grads.items()},
                                 state, {k: torch.from_numpy(v)
                                         for k, v in params.items()})
        for k in shapes:
            np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]),
                                       **TOL_TIGHT, err_msg=f"step {i} {k}")
    want = dict(_state_leaves(_np_tree(jx, jstate)))
    got = dict(_state_leaves(state))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        tol = TOL_BF16_MOMENTS if g.dtype == torch.bfloat16 else TOL_TIGHT
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(want[name], np.float32), **tol,
                                   err_msg=name)


def test_schedules_match_jax(jx):
    steps = np.arange(0, 120, 7, dtype=np.int32)
    for jfn, pfn in ((jx.optim.cosine_schedule(3e-4, 20, 100),
                      cosine_schedule(3e-4, 20, 100)),
                     (jx.optim.constant_schedule(1e-3),
                      constant_schedule(1e-3))):
        want = np.array([float(jfn(jx.jnp.int32(s))) for s in steps])
        got = np.array([float(pfn(torch.tensor(s, dtype=torch.int32)))
                        for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_quantize_dequantize_error_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    xq = quantize_dequantize(x)
    amax = float(torch.max(torch.abs(x)))
    assert float(torch.max(torch.abs(xq - x))) <= amax / 127.0 + 1e-6


def test_quantize_dequantize_matches_jax(jx):
    from repro.optim.compression import quantize_dequantize as jax_qd
    rng = np.random.default_rng(1)
    x = rng.standard_normal(4096).astype(np.float32)
    np.testing.assert_array_equal(
        quantize_dequantize(torch.from_numpy(x)).numpy(),
        np.asarray(jax_qd(jx.jnp.asarray(x))))


def test_optimizer_state_shapes_match_init():
    for opt in (AdamW(), Adafactor(), Int8ErrorFeedback(AdamW())):
        p = {"b": torch.zeros((3,)), "w": torch.zeros((4, 3))}
        state = opt.init(p)
        shapes = opt.state_shapes({k: torch.empty(v.shape, device="meta")
                                   for k, v in p.items()})
        real = {k: (tuple(v.shape), v.dtype) for k, v in _state_leaves(state)}
        spec = {k: (tuple(v.shape), v.dtype) for k, v in _state_leaves(shapes)}
        assert real == spec
        assert all(v.is_meta for _, v in _state_leaves(shapes))


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor",
                                      "int8_error_feedback"])
def test_convert_optimizer_state(jx, opt_name):
    jcfg, pcfg = _cfgs(jx, "llava-next-34b")
    jopt, popt = _optimizers(jx, opt_name)
    jstate = _np_tree(jx, jopt.init(_jax_params(jx, jcfg)))
    state = convert.optimizer_state(jstate, pcfg, device="cpu")
    want = popt.state_shapes({k: s for k, s in param_leaves(
        tf.param_shapes(pcfg))})
    assert ({k: (tuple(v.shape), v.dtype) for k, v in _state_leaves(state)}
            == {k: (tuple(v.shape), v.dtype) for k, v in _state_leaves(want)})
    with pytest.raises(ValueError):
        convert.optimizer_state({"m": {}, "v": {}, "count": 0}, pcfg, "cpu")


# --------------------------------------------------------------------------- #
# data pipeline (tests/test_data.py)                                          #
# --------------------------------------------------------------------------- #
def test_token_source_bit_equal_to_jax(jx):
    for vocab, seq, seed in ((100, 16, 5), (49152, 512, 0), (257, 33, 9)):
        a = jx.pipeline.TokenSource(vocab, seq, seed=seed)
        b = TokenSource(vocab, seq, seed=seed)
        for bs in (1, 4, 8):
            x, y = a.next(bs), b.next(bs)
            for k in ("tokens", "labels"):
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])


def test_token_source_deterministic():
    a = TokenSource(100, 16, seed=5)
    b = TokenSource(100, 16, seed=5)
    for _ in range(3):
        x, y = a.next(4), b.next(4)
        np.testing.assert_array_equal(x["tokens"], y["tokens"])


def test_token_source_resumable():
    a = TokenSource(100, 16, seed=5)
    a.next(4)
    a.next(4)
    st = a.state()
    b = TokenSource(100, 16, seed=5)
    b.restore(st)
    np.testing.assert_array_equal(a.next(4)["tokens"], b.next(4)["tokens"])


def test_labels_are_shifted_tokens():
    s = TokenSource(100, 16, seed=1)
    bt = s.next(2)
    np.testing.assert_array_equal(bt["tokens"][:, 1:], bt["labels"][:, :-1])


def test_prefetcher_order_and_stop():
    src = iter(range(100))
    pf = Prefetcher(lambda: next(src), depth=2)
    got = [pf.next() for _ in range(5)]
    pf.stop()
    assert got == [0, 1, 2, 3, 4]


def test_prefetcher_propagates_errors():
    def boom():
        raise ValueError("bad source")

    pf = Prefetcher(boom, depth=1)
    with pytest.raises(ValueError, match="bad source"):
        pf.next()
    pf.stop()


def test_shard_batch_no_mesh():
    out = shard_batch({"tokens": np.ones((4, 8), np.int32)}, device="cpu")
    assert out["tokens"].shape == (4, 8)
    assert out["tokens"].dtype == torch.int32
    assert out["tokens"].device.type == "cpu"
    # rules without a mesh place nothing (a mesh's batch sharding is held
    # in tests/test_torch_mesh_gloo.py)
    from repro_torch.distributed.sharding import TRAIN_RULES, is_dtensor
    out = shard_batch({"tokens": np.ones((4, 8), np.int32)},
                      rules=TRAIN_RULES, device="cpu")
    assert not is_dtensor(out["tokens"]) and out["tokens"].shape == (4, 8)


def test_shard_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_batch({"tokens": np.ones((4, 8), np.int32)})


# --------------------------------------------------------------------------- #
# checkpoints (tests/test_checkpoint.py)                                      #
# --------------------------------------------------------------------------- #
def _tree():
    return {
        "a": torch.arange(12.0).reshape(3, 4),
        "nested": {"b": torch.ones((2,), dtype=torch.int32),
                   "c": torch.tensor(3.5)},
    }


def _leaves(tree):
    from repro_torch.checkpoint.checkpointer import _flatten
    return [leaf for _, leaf in _flatten(tree)]


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    tree = _tree()
    ck.save(7, tree)
    assert latest_step(str(tmp_path)) == 7
    got = ck.restore(7)
    assert set(got) == {"a", "nested"} and set(got["nested"]) == {"b", "c"}
    for a, b in zip(_leaves(tree), _leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_roundtrip_of_tuples_and_bf16_is_bit_exact(tmp_path):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((5, 7)).astype(
        np.float32)).to(torch.bfloat16)
    tree = ({"w": w, "count": torch.tensor(3, dtype=torch.int32)},
            {"step": 4})
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(4, tree)
    got = ck.restore(4)
    assert isinstance(got, tuple) and got[0]["w"].dtype == torch.bfloat16
    assert torch.equal(got[0]["w"].view(torch.int16), w.view(torch.int16))
    assert int(got[1]["step"]) == 4 and got[0]["count"].dtype == torch.int32


def test_async_save_and_keep_k(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=True)
    try:
        for s in (1, 2, 3, 4):
            ck.save(s, _tree())
        ck.wait()
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(tmp_path) if n.startswith("step_")
        )
        assert steps == [3, 4]
    finally:
        ck.close()  # join the writer thread (leaked-thread guard)


def test_async_save_snapshots_before_later_updates(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    try:
        w = torch.zeros(1000)
        ck.save(1, {"w": w})
        w.add_(1.0)   # the step after the save updates in place
        ck.wait()
        assert float(ck.restore(1)["w"].abs().max()) == 0.0
    finally:
        ck.close()


def test_tmp_dirs_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(3, _tree())
    os.makedirs(os.path.join(tmp_path, "step_9.tmp"))  # simulated crash mid-save
    assert latest_step(str(tmp_path)) == 3


def test_restore_with_target_dtype_cast(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, {"w": torch.ones((4,), dtype=torch.float32)})
    target = {"w": torch.empty((4,), dtype=torch.bfloat16, device="meta")}
    got = ck.restore(1, target)
    assert got["w"].dtype == torch.bfloat16 and got["w"].device.type == "cpu"
    with pytest.raises(ValueError, match="differ"):
        ck.restore(1, {"v": torch.empty((4,), device="meta")})


def test_crash_resume_training(tmp_path):
    """Injected failure mid-run; a fresh train_loop resumes from the
    checkpoint and finishes with the SAME data order (source state saved)."""
    cfg = get_config("smollm-135m").reduce_for_smoke()
    inj = FailureInjector(fail_at=[7])
    with pytest.raises(RuntimeError, match="injected failure"):
        port_train.train_loop(cfg, steps=12, batch=2, seq=16,
                              ckpt_dir=str(tmp_path), ckpt_every=3,
                              injector=inj, device="cpu")
    resumed_from = latest_step(str(tmp_path))
    assert resumed_from == 6
    out = port_train.train_loop(cfg, steps=12, batch=2, seq=16,
                                ckpt_dir=str(tmp_path), ckpt_every=3,
                                device="cpu")
    assert np.isfinite(out["final_loss"]) and len(out["losses"]) == 6
    # uninterrupted reference run must agree on the final loss
    ref_run = port_train.train_loop(cfg, steps=12, batch=2, seq=16,
                                    ckpt_dir=None, device="cpu")
    np.testing.assert_allclose(out["final_loss"], ref_run["final_loss"],
                               rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# fault tolerance (tests/test_fault_tolerance.py)                             #
# --------------------------------------------------------------------------- #
def test_fault_tolerance_module_is_the_reference():
    src = os.path.join(ROOT, "src")
    want = open(os.path.join(src, "repro", "distributed",
                             "fault_tolerance.py")).read()
    got = open(os.path.join(src, "repro_torch", "distributed",
                            "fault_tolerance.py")).read()
    assert got == re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.",
                         want, flags=re.M)


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(k=5.0, min_samples=5)
    events = []
    wd.on_straggler = events.append
    for _ in range(20):
        wd.observe(0.100)
    ev = wd.observe(1.0)  # 10x slower
    assert ev is not None and ev.seconds == 1.0
    assert events and events[0].threshold < 1.0


def test_watchdog_tolerates_noise():
    rnd = random.Random(0)
    wd = StepWatchdog(k=6.0)
    for _ in range(100):
        assert wd.observe(0.1 + rnd.uniform(-0.005, 0.005)) is None


def test_watchdog_window_adapts():
    wd = StepWatchdog(k=5.0, window=20)
    for _ in range(20):
        wd.observe(0.1)
    flags = [wd.observe(0.3) is not None for _ in range(40)]
    assert any(flags[:20])          # transition is flagged
    assert not any(flags[20:])      # adapted after a full window


def test_failure_injector_fires_once():
    inj = FailureInjector([3])
    inj.check(1)
    inj.check(2)
    with pytest.raises(RuntimeError):
        inj.check(3)
    inj.check(3)  # second pass: already consumed
    assert inj.failures == 1


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_in_slices_and_in_place(monkeypatch, moment_dtype):
    """AdamW.update writes the moments into the state it is given, a slice
    at a time: the same bits as in one slice, the same tensors returned."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(8)
    shapes = {"a": (5, 13), "b": (7,), "c": (0, 4), "d": ()}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    opt = AdamW(schedule=constant_schedule(0.01), weight_decay=0.1,
                moment_dtype=moment_dtype)
    runs = []
    for slice_ in (adamw.UPDATE_SLICE, 7):
        monkeypatch.setattr(adamw, "UPDATE_SLICE", slice_)
        state = opt.init(params)
        m_before = dict(state["m"])
        for i in range(3):
            grads = {k: torch.from_numpy(np.random.default_rng(i).standard_normal(
                s).astype(np.float32)) for k, s in shapes.items()}
            upd, state = opt.update(grads, state, params)
        assert all(state["m"][k] is m_before[k] for k in shapes)
        runs.append((upd, state))
    (u1, s1), (u2, s2) = runs
    for k in shapes:
        assert torch.equal(u1[k], u2[k]) and u1[k].dtype == torch.float32
        for part in ("m", "v"):
            assert torch.equal(s1[part][k], s2[part][k])
            assert s1[part][k].dtype == getattr(torch, moment_dtype)


def test_heartbeat(tmp_path):
    hb = Heartbeat(os.path.join(tmp_path, "hb"))
    hb.beat(42)
    with open(os.path.join(tmp_path, "hb")) as f:
        assert f.read().startswith("42 ")


# --------------------------------------------------------------------------- #
# the train loop's entry points and the examples                             #
# --------------------------------------------------------------------------- #
def test_train_main_on_the_cpu(tmp_path, capsys):
    port_train.main(["--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
                     "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert "final_loss=" in capsys.readouterr().out
    assert latest_step(str(tmp_path)) == 3


def test_train_main_refuses_a_mesh_and_defaults_to_the_card(monkeypatch):
    # --mesh needs a launched world (torchrun); a mesh's training is held
    # in tests/test_torch_mesh_gloo.py
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        port_train.main(["--smoke", "--steps", "1", "--device", "cpu",
                         "--mesh"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_train.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("arch", ["grok-1-314b"])
def test_families_without_a_train_step_raise_at_build(arch):
    cfg = get_config(arch).reduce_for_smoke()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_train.build(cfg)


def test_train_lm_example_learns(tmp_path):
    from repro_torch.examples import train_lm
    train_lm.main(["--steps", "12", "--batch", "4", "--seq", "32",
                   "--device", "cpu", "--ckpt-dir", str(tmp_path)])


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_review_analytics_matches_the_jax_example(jx):
    """UC4 at the reference's config and flags (200 reviews, a 30-step
    probe): the same initial weights, carried across; the tuned weights
    within 1e-4 relative (the 2-norm of each leaf's difference against
    its own: 30 AdamW steps move an element whose gradient is near float32
    noise by a sign-like update, so single elements may differ more); the
    port's rows equal its whole-table oracle under every eddy policy; against the
    JAX example's rows they may differ only where the score is within
    1e-4 of 0."""
    from repro_torch.core.policies import EDDY_POLICIES
    from repro_torch.examples import review_analytics as port_ex
    jax_ex = _jax_example("review_analytics")
    jcfg = jx.configs.get_config("smollm-135m").reduce_for_smoke()
    jparams = jx.tf.init_params(jcfg, jx.jax.random.key(0))
    cfg = get_config("smollm-135m").reduce_for_smoke()
    init = convert.model_params(_np_tree(jx, jparams), cfg, device="cpu")
    out = port_ex.main(["--device", "cpu"], params=init)
    jtuned = jax_ex.train_probe(jcfg, jparams, 30)
    want = dict(param_leaves(_np_tree(jx, jtuned)))
    for name, value in stacked(out["params"], tf.param_shapes(cfg)).items():
        w = np.asarray(want[name], np.float32)
        rel = np.linalg.norm(value.numpy() - w) / np.linalg.norm(w)
        assert rel <= 1e-4, (name, rel)
    reviews = out["reviews"]
    expect = port_ex.oracle(out["llm"], reviews)
    for name in sorted(EDDY_POLICIES):
        rows, _, _ = port_ex.run_query(out["llm"], reviews,
                                       EDDY_POLICIES[name]())
        assert set(rows) == expect, name
    jllm = jax_ex.build_llm_udf(jtuned, jcfg)
    toks = port_ex.pad([r.tokens for r in reviews])
    jscores = np.asarray(jllm.fn({"tokens": toks}))
    jrows = {r.rid for r, s in zip(reviews, jscores)
             if r.rating <= 1 and s > 0}
    differ = jrows ^ set(out["matched"])
    near = {r.rid for r, s in zip(reviews, jscores) if abs(s) <= 1e-4}
    print(f"UC4: {len(differ)} rows differ from the JAX example's, "
          f"{len(near)} scores within 1e-4 of 0")
    assert differ <= near, (sorted(differ - near), len(near))
