"""Kernel-backed predicates of the port through its AQPExecutor, on the CPU.

The hsv_color rows of the JAX package's tests/test_kernel_udfs.py: the
executor's answer equals the oracle (and the JAX package's), launches land
on the StatsBoard under the kernel's name, the hook is deregistered after
a run and after a worker error, zero-row batches and bucket padding behave,
and a predicate named after its kernel keeps its own entry.
"""
import numpy as np
import torch
import pytest

import repro.core as jax_core
import repro.udfs as jax_udfs
import repro_torch.core as port_core
from repro_torch import udfs
from repro_torch.core import AQPExecutor, CostDriven, make_batch
from repro_torch.core.udf import UDF, bucket_rows
from repro_torch.kernels import hsv_color, launch

# small tensors: one intra-op thread, so these tests do not crowd the
# timing-sensitive executor tests running beside them
torch.set_num_threads(1)

SIZE = 8     # crop height/width for the hsv predicate


def _dataset(n=24, seed=0):
    """Crops with a planted dark third, plus a row id column."""
    rng = np.random.default_rng(seed)
    crops = rng.uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32)
    crops[: n // 3] = rng.uniform(0, 40, (n // 3, SIZE, SIZE, 3))  # black-ish
    return {"crop": crops, "rid": np.arange(n)}


def _batches(core, data, per=6):
    n = len(data["crop"])
    return [
        core.make_batch({k: v[i:i + per] for k, v in data.items()},
                        np.arange(i, min(i + per, n)))
        for i in range(0, n, per)
    ]


def _oracle_ids(preds, data):
    n = len(next(iter(data.values())))
    mask = np.ones(n, bool)
    for p in preds:
        mask &= p.mask_from_outputs(p.udf(data))
    return set(np.nonzero(mask)[0].tolist())


def _make_preds(package, **device):
    return [package.color_predicate("black", size=SIZE, **device),
            package.planted_predicate("odd", range(1, 24, 2),
                                      cost_per_row=1e-4)]


def _total_hooks():
    return len(launch._HOOKS) + sum(map(len, launch._TOKEN_HOOKS.values()))


def test_executor_populates_stats_board_with_kernel_costs():
    data = _dataset()
    preds = _make_preds(udfs, device="cpu")
    expect = _oracle_ids(preds, data)
    assert 0 < len(expect) < len(data["crop"])

    ex = AQPExecutor(preds, policy=CostDriven(), max_workers=2)
    got = {int(i) for b in ex.run(iter(_batches(port_core, data)))
           for i in b.row_ids}
    assert got == expect

    # the JAX package's executor over its own predicates agrees
    jpreds = _make_preds(jax_udfs, impl="xla")
    jex = jax_core.AQPExecutor(jpreds, policy=jax_core.CostDriven(),
                               max_workers=2)
    assert {int(i) for b in jex.run(iter(_batches(jax_core, data)))
            for i in b.row_ids} == expect

    snap = ex.stats_snapshot()
    assert snap["hsv_color"]["batches"] > 0
    assert snap["hsv_color"]["cost_per_row"] > 0
    for p in preds:
        assert snap[p.name]["batches"] > 0


def test_hook_deregistered_after_run_and_no_double_count():
    data = _dataset()
    preds = _make_preds(udfs, device="cpu")
    hooks_before = _total_hooks()

    ex1 = AQPExecutor(preds, policy=CostDriven(), max_workers=2)
    list(ex1.run(iter(_batches(port_core, data))))
    assert _total_hooks() == hooks_before, "run() leaked its launch hook"
    assert ex1._kernel_hook is None
    launches1 = ex1.stats_snapshot()["hsv_color"]["batches"]

    # a launch outside any run must not reach the (shut-down) executor board
    udfs.color_predicate("black", size=SIZE, device="cpu").udf(
        {"crop": data["crop"][:4]})
    assert ex1.stats_snapshot()["hsv_color"]["batches"] == launches1

    ex2 = AQPExecutor(preds, policy=CostDriven(), max_workers=2)
    list(ex2.run(iter(_batches(port_core, data))))
    assert ex2.stats_snapshot()["hsv_color"]["batches"] > 0
    assert ex1.stats_snapshot()["hsv_color"]["batches"] == launches1
    assert _total_hooks() == hooks_before


def test_hook_deregistered_when_worker_raises():
    def boom(d):
        raise ValueError("planted failure")

    bad = udfs.planted_predicate("ok", range(5), cost_per_row=1e-4)
    bad.udf.fn = boom
    hooks_before = _total_hooks()
    ex = AQPExecutor([bad], max_workers=1)
    with pytest.raises(RuntimeError, match="planted failure"):
        list(ex.run(iter([make_batch({"rid": np.arange(5)}, np.arange(5))])))
    assert _total_hooks() == hooks_before
    assert ex._kernel_hook is None


def test_zero_row_path_works_for_every_kernel_predicate():
    for kernel in sorted(udfs.KERNEL_PREDICATES):
        p = udfs.build_predicate(kernel, size=SIZE, device="cpu")
        empty = {k: v[:0] for k, v in _dataset(n=6).items()}
        out = p.udf(empty)
        assert out.shape[0] == 0
        assert p.mask_from_outputs(out).shape == (0,)


def test_zero_row_udf_never_calls_fn_with_empty_arrays():
    seen = []

    def fn(d):
        seen.append(len(d["x"]))
        assert len(d["x"]) > 0, "zero-row probe must synthesize a row"
        return (d["x"].sum(-1) > 0).astype(np.int32)

    udf = UDF("u", fn, columns=("x",))
    out = udf({"x": np.zeros((0, 3), np.float32)})
    assert out.shape == (0,) and out.dtype == np.int32
    again = udf({"x": np.zeros((0, 3), np.float32)})
    assert again.shape == (0,) and seen == [1]


def test_bucket_padding_matches_unbucketed_outputs():
    p = udfs.build_predicate("hsv_color", size=SIZE, device="cpu")
    data = _dataset(n=5, seed=3)   # 5 -> bucketed to 8
    assert bucket_rows(5) == 8
    events = []
    with launch.launch_hooks(events.append):
        bucketed = p.udf(data)     # pads to 8 rows, slices back
    assert [e.rows for e in events if e.rows > 1] == [8]
    p.udf.bucket = False
    np.testing.assert_array_equal(bucketed, p.udf(data))


def test_warm_fn_launches_once_and_teaches_the_output_spec():
    events = []
    p = udfs.color_predicate("black", size=SIZE, device="cpu")
    with launch.launch_hooks(events.append):
        p.udf.ensure_ready()
        p.udf.ensure_ready()
        assert [(e.name, e.rows) for e in events] == [("hsv_color", 1)]
        out = p.udf({"crop": np.zeros((0, SIZE, SIZE, 3), np.float32)})
        assert out.shape == (0,) and len(events) == 1


def test_kernel_name_colliding_with_predicate_name_is_namespaced():
    data = _dataset()
    pred = udfs.color_predicate("black", size=SIZE, device="cpu",
                                name="hsv_color")
    other = udfs.planted_predicate("odd", range(1, 24, 2), cost_per_row=1e-4)
    expect = _oracle_ids([pred, other], data)

    ex = AQPExecutor([pred, other], policy=CostDriven(), max_workers=2)
    got = {int(i) for b in ex.run(iter(_batches(port_core, data)))
           for i in b.row_ids}
    assert got == expect
    snap = ex.stats_snapshot()
    assert snap["kernel:hsv_color"]["batches"] > 0
    assert snap["hsv_color"]["selectivity"] < 1.0


def test_detector_launches_are_hooked_and_classifier_launches_are_not():
    """The board's hsv_color entry counts the same launches in both
    packages: the detector reports each launch, the classifier (the JAX
    package's impl="xla" stand-in) reports none."""
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (4, SIZE, SIZE, 3)).astype(np.float32)
    det = udfs.planted_detector("det", np.array([1, 0, 1, 0], bool),
                                work_dim=SIZE, device="cpu")
    cls = udfs.planted_classifier("cls", 2, label_column="y", device="cpu")
    events = []
    before = hsv_color.launches
    with launch.launch_hooks(events.append):
        got = det.udf({"frame": frames, "rid": np.arange(4)})
        labels = cls.udf({"crop": frames, "y": np.array([2, 1, 2, 0])})
    assert got.tolist() == [True, False, True, False]
    assert cls.mask_from_outputs(labels).tolist() == [True, False, True, False]
    # warm probe + one launch, both from the detector
    assert [(e.name, e.rows) for e in events] == [("hsv_color", 1),
                                                   ("hsv_color", 4)]
    assert hsv_color.launches == before  # CPU tensors: no kernel launch


def test_registry_and_fingerprints():
    with pytest.raises(KeyError, match="no kernel predicate"):
        udfs.build_predicate("moe_router")
    with pytest.raises(ValueError, match="already registered"):
        udfs.register_kernel_predicate("hsv_color", udfs.color_predicate)
    black = udfs.color_predicate("black", size=SIZE, device="cpu")
    white = udfs.color_predicate("white", size=SIZE, device="cpu")
    assert black.udf.fingerprint != white.udf.fingerprint
    assert black.udf.resource == "cuda:0"
