"""UC1: the lost-dog query (paper Listing 2) end to end, on the card.

SELECT id, bbox FROM video
CROSS APPLY UNNEST(ObjectDetector(frame)) AS Object(label, bbox, score)
WHERE Object.label='dog'
  AND DogBreedClassifier(Crop(frame, bbox)) = 'great dane'
  AND DogColorClassifier(Crop(frame, bbox)) = 'black';

Both predicates come from ``repro_torch.udfs``: the color classifier runs
the hand-written HSV kernel — its per-launch timings show up in the routing
statistics under "hsv_color" because the executor connects kernel launch
hooks to its StatsBoard — and the breed classifier is a planted-label
stand-in that runs the same kernel without the hooks.
Compare routing policies with --policy; --device cpu runs the plain version.

  PYTHONPATH=src python -m repro_torch.examples.lost_dog_query --device cuda --policy hydro
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Iterator

import numpy as np

from repro_torch import udfs
from repro_torch.core import Query, optimize
from repro_torch.core.policies import EDDY_POLICIES
from repro_torch.data.video import BREEDS, SyntheticVideo, crop_to_canonical


def dog_table(video: SyntheticVideo) -> Dict[str, np.ndarray]:
    """Scan + ObjectDetector + UNNEST + label='dog' + Crop, built once:
    one row per dog, with its 64x64 float32 crop."""
    dogs = [o for o in video.objects if o.label == "dog"]
    return {
        "crop": np.stack(
            [crop_to_canonical(video.crop(o.frame_id, o.bbox)) for o in dogs]
        ).astype(np.float32),
        "frame_id": np.array([o.frame_id for o in dogs], np.int64),
        "bbox": np.array([o.bbox for o in dogs], np.int64),
        "breed_gt": np.array([BREEDS.index(o.breed) for o in dogs], np.int64),
        "_row_id": np.arange(len(dogs)),
    }


def source(table: Dict[str, np.ndarray], chunk: int = 32) -> Iterator[dict]:
    """The table in ``chunk``-row pieces, as the detector would emit them."""
    n = len(table["_row_id"])
    for i in range(0, n, chunk):
        yield {k: v[i:i + chunk] for k, v in table.items()}


def build_plan(table, *, policy: str = "hydro", device="cuda",
               breed: str = "great dane", color: str = "black",
               max_workers: int = 4):
    """The lost-dog query over ``table`` as an adaptive plan."""
    p_breed = udfs.planted_classifier(
        "DogBreedClassifier", BREEDS.index(breed),
        label_column="breed_gt", pixel_column="crop", device=device,
        resource="cuda:0",
    )
    p_color = udfs.color_predicate(
        color, size=64, device=device, resource="cpu",
        name="DogColorClassifier",
    )
    q = Query(source=source(table), predicates=[p_breed, p_color],
              project=("frame_id", "bbox"))
    return q, optimize(q, executor_kwargs=dict(
        policy=EDDY_POLICIES[policy](), max_workers=max_workers,
    ))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--policy", default="hydro", choices=sorted(EDDY_POLICIES))
    ap.add_argument("--breed", default="great dane")
    ap.add_argument("--color", default="black")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    video = SyntheticVideo(num_frames=args.frames, seed=7)
    q, plan = build_plan(dog_table(video), policy=args.policy,
                         device=args.device, breed=args.breed,
                         color=args.color)
    print("plan:", " -> ".join(plan.description))
    t0 = time.perf_counter()
    rows = plan.collect_rows()
    dt = time.perf_counter() - t0

    n = len(rows["_row_id"])
    print(f"\nfound {n} {args.color} {args.breed} sightings in {dt:.2f}s "
          f"on {args.device}:")
    for fid, bbox in list(zip(rows["frame_id"], rows["bbox"]))[:10]:
        print(f"  frame {int(fid):4d}  bbox {tuple(int(b) for b in bbox)}")
    if n > 10:
        print(f"  ... and {n - 10} more")
    print("\nrouting statistics (collected at run time, no priors):")
    pred_names = {p.name for p in q.predicates}
    snap = plan.executor.stats_snapshot()
    for name, s in snap.items():
        if name not in pred_names:
            continue
        print(f"  {name}: cost/row={s['cost_per_row']*1e3:.2f}ms "
              f"selectivity={s['selectivity']:.3f} score={s['score']*1e3:.2f}")
    kernel_rows = {n: s for n, s in snap.items()
                   if n not in pred_names and not n.startswith("_")}
    if kernel_rows:
        print("per-kernel launch cost (launch hooks -> same StatsBoard):")
        for name, s in kernel_rows.items():
            print(f"  {name}: cost/row={s['cost_per_row']*1e3:.3f}ms "
                  f"launches={int(s['batches'])}")


if __name__ == "__main__":
    main()
