"""The UC1 lost-dog query (paper Listing 2) through the port on the CPU,
against the JAX package: the same row ids under every eddy policy, the
same synthetic video, and a ReuseCache snapshot that the JAX package
flushed loads in the port and gives the same hits."""
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.data.video as jax_video
import repro.udfs as jax_udfs
from repro.core.policies import EDDY_POLICIES
from repro_torch import convert
from repro_torch.core import ReuseCache, optimize
from repro_torch.data import video as port_video
from repro_torch.examples import lost_dog_query as example
from repro_torch.kernels import ref

# small tensors: one intra-op thread, so these tests do not crowd the
# timing-sensitive executor tests running beside them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def table():
    return example.dog_table(port_video.SyntheticVideo(num_frames=120, seed=3))


def _jax_rows(policy: str) -> set:
    """The JAX package's lost-dog query, as examples/lost_dog_query.py
    builds it, with the color predicate on its XLA reference path."""
    video = jax_video.SyntheticVideo(num_frames=120, seed=3)
    dogs = [o for o in video.objects if o.label == "dog"]

    def source(chunk=32):
        for i in range(0, len(dogs), chunk):
            part = dogs[i:i + chunk]
            yield {
                "crop": np.stack([
                    jax_video.crop_to_canonical(video.crop(o.frame_id, o.bbox))
                    for o in part]).astype(np.float32),
                "frame_id": np.array([o.frame_id for o in part]),
                "breed_gt": np.array(
                    [jax_video.BREEDS.index(o.breed) for o in part]),
                "_row_id": np.arange(i, i + len(part)),
            }

    p_breed = jax_udfs.planted_classifier(
        "DogBreedClassifier", jax_video.BREEDS.index("great dane"),
        label_column="breed_gt", pixel_column="crop", resource="cuda:0")
    p_color = jax_udfs.color_predicate("black", size=64, impl="xla",
                                       resource="cpu",
                                       name="DogColorClassifier")
    q = jax_core.Query(source=source(), predicates=[p_breed, p_color])
    plan = jax_core.optimize(q, executor_kwargs=dict(
        policy=EDDY_POLICIES[policy](), max_workers=2))
    return set(plan.collect_rows()["_row_id"].tolist())


@pytest.mark.parametrize("policy", sorted(EDDY_POLICIES))
def test_port_query_returns_the_reference_rows(table, policy):
    _, plan = example.build_plan(table, policy=policy, device="cpu",
                                 max_workers=2)
    rows = plan.collect_rows()
    got = set(rows["_row_id"].tolist())
    assert got == _jax_rows(policy)
    assert got  # planted data guarantees matches
    snap = plan.executor.stats_snapshot()
    assert snap["hsv_color"]["batches"] > 0  # launches reached the board


def test_static_and_adaptive_plans_agree(table):
    q, adaptive = example.build_plan(table, device="cpu", max_workers=2)
    static = optimize(
        type(q)(source=example.source(table), predicates=q.predicates),
        aqp=False)
    assert set(static.collect_rows()["_row_id"].tolist()) == set(
        adaptive.collect_rows()["_row_id"].tolist())


@pytest.mark.parametrize("seed", [3, 7])
def test_video_objects_frames_and_crops_match_the_reference(seed):
    ref_v = jax_video.SyntheticVideo(num_frames=40, seed=seed)
    port_v = port_video.SyntheticVideo(num_frames=40, seed=seed)
    assert [vars(o) for o in port_v.objects] == [vars(o) for o in ref_v.objects]
    for f in range(0, 40, 3):
        np.testing.assert_array_equal(port_v.frame(f), ref_v.frame(f))
        assert ([vars(o) for o in port_v.detections(f)]
                == [vars(o) for o in ref_v.detections(f)])
    for o in port_v.objects[:12]:
        np.testing.assert_array_equal(
            port_video.crop_to_canonical(port_v.crop(o.frame_id, o.bbox)),
            jax_video.crop_to_canonical(ref_v.crop(o.frame_id, o.bbox)))
    assert ([vars(o) for o in port_v.ground_truth("poodle", "black")]
            == [vars(o) for o in ref_v.ground_truth("poodle", "black")])


@pytest.mark.parametrize("seed", [3, 7])
def test_classify_color_batch_matches_the_reference(seed):
    v = port_video.SyntheticVideo(num_frames=30, seed=seed)
    crops = np.stack([
        port_video.crop_to_canonical(v.crop(o.frame_id, o.bbox))
        for o in v.objects if o.label == "dog"]).astype(np.float32)
    assert (port_video.classify_color_batch(crops)
            == jax_video.classify_color_batch(crops))


def test_reuse_cache_flushed_by_the_reference_loads_in_the_port(tmp_path, table):
    """State carried across: the JAX package's cache snapshot gives the
    port the same hits, values and hit rates."""
    path = str(tmp_path / "uc2_cache")
    jcache = jax_core.ReuseCache(path)
    labels = ref.hsv_color_classify(torch.from_numpy(table["crop"]))[1].numpy()
    ids = table["_row_id"]
    jcache.put("DogColorClassifier", ids[::2], labels[::2])
    jcache.put("DogBreedClassifier", ids[:7], table["breed_gt"][:7])
    jcache.put("detector", np.array([100, 101]),
               [np.zeros(3, np.float32), np.ones(5, np.float32)])  # ragged
    jcache.flush()

    pcache = convert.reuse_cache(path)
    assert isinstance(pcache, ReuseCache)
    probe = np.arange(len(ids) + 3)
    for udf in ("DogColorClassifier", "DogBreedClassifier", "detector"):
        jh, jv = jcache.probe(udf, probe)
        ph, pv = pcache.probe(udf, probe)
        np.testing.assert_array_equal(ph, jh)
        for a, b in zip(pv, jv):
            assert (a is None and b is None) or np.array_equal(a, b)
        assert pcache.hit_rate(udf, probe) == jcache.hit_rate(udf, probe)
    np.testing.assert_array_equal(pcache.probe("detector", [101])[1][0],
                                  np.ones(5, np.float32))


def test_reuse_cache_conversion_refuses_damaged_snapshots(tmp_path):
    with pytest.raises(FileNotFoundError):
        convert.reuse_cache(str(tmp_path / "missing"))
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **{"u__g0__ids": np.arange(3, dtype=np.int64),
                     "u__g0__vals": np.zeros(2)})
    with pytest.raises(ValueError, match="differ in length"):
        convert.reuse_cache(bad)
    stray = str(tmp_path / "stray.npz")
    np.savez(stray, other=np.zeros(2))
    with pytest.raises(ValueError, match="unexpected entry"):
        convert.reuse_cache(stray)
