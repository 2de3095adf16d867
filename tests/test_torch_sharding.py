"""The port's sharding rules (``repro_torch.distributed``) against the JAX
package's, in one process.

``spec_for`` is held to the JAX package's ``PartitionSpec`` (as tuples)
for every parameter leaf of every full config, under both rule sets, on
(16, 16) and (2, 16, 16) meshes (duck-typed: only the axis names and
sizes are read); the families' ``param_logical`` (moe with and without
``moe_serve_ep2d``), ``cache_logical`` and every optimizer's
``state_logical`` leaf for leaf, with the reference's tree paths joined
into the port's dotted names; ``split_mesh_data_axis``'s slices of the
rank tensor to the reference's slices of its device array; and the
reference's own unit cases (``tests/test_sharding.py``). Meshes of real
processes are in tests/test_torch_mesh_gloo.py.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.distributed import meshes
from repro_torch.distributed.sharding import (
    SERVE_RULES,
    TRAIN_RULES,
    constrain,
    parse_dims,
    placements_for,
    spec_for,
)
from repro_torch.models.layers import NULL_CTX, ShardCtx
from repro_torch.models.params import param_leaves
from repro_torch.models.registry import model_api
from repro_torch.optim import AdamW, Adafactor
from repro_torch.optim.compression import Int8ErrorFeedback


class FakeMesh:
    """Duck-typed mesh: the port reads ``mesh_dim_names`` and ``shape``,
    the reference ``axis_names`` and ``devices.shape``."""

    def __init__(self, shape, names):
        self.mesh_dim_names = self.axis_names = names
        self.shape = shape
        self.devices = np.empty(shape, dtype=object)


MESH = FakeMesh((16, 16), ("data", "model"))
POD = FakeMesh((2, 16, 16), ("pod", "data", "model"))
RULES = {"train": TRAIN_RULES, "serve": SERVE_RULES}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here: the port imports none)."""
    jax = pytest.importorskip("jax")
    from repro import configs as jax_configs
    from repro.distributed import meshes as jax_meshes
    from repro.distributed import sharding as jax_sharding
    from repro.models.registry import model_api as jax_model_api
    from repro.optim import adamw as jax_adamw
    from repro.optim import compression as jax_compression

    def cfg(port_cfg):
        return jax_configs.base.ModelConfig(**dataclasses.asdict(port_cfg))

    def flat(tree):
        """{dotted path: leaf} of a pytree of strings or arrays."""
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path)] = leaf
        return out

    return types.SimpleNamespace(jax=jax, sharding=jax_sharding,
                                 meshes=jax_meshes, model_api=jax_model_api,
                                 adamw=jax_adamw, compression=jax_compression,
                                 cfg=cfg, flat=flat)


def _port_flat(tree):
    return dict(param_leaves(tree))


def _configs():
    out = [(a, {}) for a in sorted(ARCHS)]
    out += [(a, {"moe_serve_ep2d": True}) for a in sorted(ARCHS)
            if ARCHS[a].family == "moe"]
    return out


def _id(case):
    arch, kw = case
    return arch + ("+ep2d" if kw else "")


# --------------------------------------------------------------------------- #
# the reference's unit cases                                                   #
# --------------------------------------------------------------------------- #
def test_parse_dims():
    assert parse_dims("layers d_model_w d_ff") == ("layers", "d_model_w", "d_ff")
    assert parse_dims("batch . d_model") == ("batch", None, "d_model")
    assert parse_dims("") == ()


def test_divisible_dims_shard():
    assert spec_for((4096, 11008), "d_model_w d_ff", TRAIN_RULES, MESH) == \
        ("data", "model")


def test_indivisible_dims_replicate():
    # yi-6b kv=4 over a 16-way model axis -> replicated
    assert spec_for((4096, 4, 128), "d_model_w kv_heads .", TRAIN_RULES,
                    MESH) == ("data", None, None)


def test_axis_claimed_once():
    # experts claims 'model'; d_ff then falls back to replicated
    assert spec_for((35, 128, 7168, 4864), "layers experts expert_dw d_ff",
                    TRAIN_RULES, MESH) == (None, "model", "data", None)
    # grok: 8 experts do NOT divide 16 -> d_ff gets 'model' instead
    assert spec_for((64, 8, 6144, 32768), "layers experts expert_dw d_ff",
                    TRAIN_RULES, MESH) == (None, None, "data", "model")


def test_batch_axes_multipod():
    assert spec_for((256, 4096), "batch seq", TRAIN_RULES, POD) == \
        (("pod", "data"), None)
    assert spec_for((256, 4096), "batch seq", TRAIN_RULES, MESH) == \
        ("data", None)


def test_serve_rules_no_fsdp_for_dense():
    assert spec_for((4096, 14336), "d_model_w d_ff", SERVE_RULES, MESH) == \
        (None, "model")


def test_decode_cache_seq_sharded():
    assert spec_for((32, 128, 32768, 8, 128),
                    "layers batch cache_seq kv_heads .", SERVE_RULES, MESH) \
        == (None, "data", "model", None, None)


def test_placements_of_a_two_axis_dim():
    """A dim over ("pod", "data") is Shard(d) on both, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    spec = spec_for((256, 4096, 64), "batch seq d_ff", TRAIN_RULES, POD)
    assert spec == (("pod", "data"), None, "model")
    assert placements_for(spec, POD) == (Shard(0), Shard(0), Shard(2))
    assert placements_for((None, None), MESH) == (Replicate(), Replicate())


def test_no_mesh_is_the_identity():
    x = torch.ones(2, 3)
    assert NULL_CTX.constrain(x, "batch seq") is x
    assert NULL_CTX.axis_size("model") == 1
    assert constrain(x, "batch seq", TRAIN_RULES, MESH) is x
    assert ShardCtx(MESH, TRAIN_RULES).axis_size("model") == 16
    assert NULL_CTX.local(lambda a: a + 1, (x,), ("batch seq",), (0,)).equal(
        x + 1)


# --------------------------------------------------------------------------- #
# against the JAX package                                                      #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh", [MESH, POD], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_for_every_param_leaf_matches_the_reference(jx, arch, rules,
                                                         mesh):
    cfg = ARCHS[arch]
    api, japi, jcfg = model_api(cfg), jx.model_api(jx.cfg(cfg)), jx.cfg(cfg)
    shapes = _port_flat(api.param_shapes(cfg))
    logical = _port_flat(api.param_logical(cfg))
    jshapes = jx.flat(japi.param_shapes(jcfg))
    jlogical = jx.flat(japi.param_logical(jcfg))
    assert sorted(shapes) == sorted(jshapes)
    r, jr = RULES[rules], getattr(jx.sharding, f"{rules.upper()}_RULES")
    for name, s in shapes.items():
        assert tuple(s.shape) == tuple(jshapes[name].shape), name
        want = tuple(jx.sharding.spec_for(jshapes[name].shape,
                                          jlogical[name], jr, mesh))
        assert spec_for(s.shape, logical[name], r, mesh) == want, name


@pytest.mark.parametrize("rules", sorted(RULES))
def test_tree_placements_match_the_reference_shardings(jx, rules):
    """``tree_placements`` over a family's nested shapes and logical dims
    gives, leaf for leaf, the placements of the reference's
    ``tree_named_shardings`` specs."""
    from repro_torch.distributed.sharding import tree_placements

    cfg = ARCHS["arctic-480b"]
    jcfg = jx.cfg(cfg)
    japi = jx.model_api(jcfg)
    jrules = getattr(jx.sharding, f"{rules.upper()}_RULES")
    jshapes = jx.flat(japi.param_shapes(jcfg))
    want = {k: jx.sharding.spec_for(jshapes[k].shape, lg, jrules, MESH)
            for k, lg in jx.flat(japi.param_logical(jcfg)).items()}
    api = model_api(cfg)
    got = _port_flat(tree_placements(api.param_shapes(cfg),
                                     api.param_logical(cfg), RULES[rules],
                                     MESH))
    assert got == {k: placements_for(tuple(v), MESH) for k, v in want.items()}


@pytest.mark.parametrize("case", _configs(), ids=_id)
def test_param_logical_matches_the_reference(jx, case):
    arch, kw = case
    cfg = dataclasses.replace(ARCHS[arch], **kw)
    got = _port_flat(model_api(cfg).param_logical(cfg))
    want = jx.flat(jx.model_api(jx.cfg(cfg)).param_logical(jx.cfg(cfg)))
    assert got == want


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_logical_matches_the_reference(jx, arch):
    cfg = ARCHS[arch]
    api = model_api(cfg)
    jcfg = jx.cfg(cfg)
    jshapes, jlogical = jx.model_api(jcfg).cache_shapes(jcfg, 8, 1024)
    assert _port_flat(api.cache_logical(cfg)) == jx.flat(jlogical)
    got = {k: tuple(v.shape) for k, v in
           _port_flat(api.cache_shapes(cfg, 8, 1024)).items()}
    assert got == {k: tuple(v.shape) for k, v in jx.flat(jshapes).items()}


OPTIMIZERS = {   # (the port's optimizer, the reference's from its modules)
    "adamw": (AdamW, lambda jx: jx.adamw.AdamW()),
    "adafactor": (Adafactor, lambda jx: jx.adamw.Adafactor()),
    "int8_ef": (lambda: Int8ErrorFeedback(AdamW()),
                lambda jx: jx.compression.Int8ErrorFeedback(jx.adamw.AdamW())),
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("arch", ["smollm-135m", "grok-1-314b",
                                  "recurrentgemma-9b", "whisper-small",
                                  "mamba2-370m"])
def test_optimizer_state_logical_matches_the_reference(jx, arch, opt):
    cfg = ARCHS[arch]
    make, jmake = OPTIMIZERS[opt]
    jopt = jmake(jx)
    jcfg = jx.cfg(cfg)
    want = jx.flat(jopt.state_logical(
        jx.model_api(jcfg).param_logical(jcfg)))
    got = _port_flat(make().state_logical(
        _port_flat(model_api(cfg).param_logical(cfg))))
    assert got == want


SHARES = [
    ({"a": 3.0, "b": 1.0}, (8, 2)),
    ({"a": 1.0, "b": 1.0, "c": 1.0}, (8, 2)),          # remainder rule
    ({"big": 0.97, "tiny": 0.01, "mid": 0.02}, (16, 1)),  # one-row share
    ({"x": 5.0, "y": 2.0, "z": 2.0, "w": 1.0}, (6, 4)),
    ({"only": 1.0}, (4, 2)),
]


@pytest.mark.parametrize("shares,shape", SHARES)
def test_split_mesh_data_axis_slices_match_the_reference(jx, monkeypatch,
                                                         shares, shape):
    """The port's slices of the rank tensor equal the reference's slices
    of its device array, with device indices standing in for devices."""
    monkeypatch.setattr(jx.meshes, "Mesh", lambda devs, names: devs)
    ref_mesh = types.SimpleNamespace(
        axis_names=("data", "model"),
        devices=np.arange(np.prod(shape)).reshape(shape))
    ranks = torch.arange(int(np.prod(shape))).reshape(shape)
    got = meshes.data_slices(ranks, 0, meshes.cost_shares(shares))
    want = jx.meshes.split_mesh_data_axis(ref_mesh,
                                          jx.meshes.cost_shares(shares))
    assert list(got) == list(want)
    for n in want:
        assert got[n].tolist() == np.asarray(want[n]).tolist(), n
    assert meshes.cost_shares(shares) == jx.meshes.cost_shares(shares)
