"""Chip smoke test of the PyTorch port: build, check and time its kernels
on one CUDA card, then drive the UC1 lost-dog query through them.

    python3 chip_smoke.py

Needs a CUDA card and nvcc; exits non-zero without them, and on any
failed phase. Phases, in order:

1. setup   — card name and power limit, torch/CUDA/nvcc versions;
2. build   — compile every kernel from the sources in the checkout;
3. kernels — each kernel against its plain PyTorch version on the card,
             then timed with CUDA events beside its bound;
4. query   — the lost-dog query (5 minutes of 30-fps video) on the card
             under every eddy policy; row ids against the plain version
             on the CPU, launches on the kernel counter and the board;
5. detector — planted detectors with adaptive coalescing (fused launches
             of varying batch size) against the planted expectation;
6. the ``{"kernels": [...]}`` line, then the device line last.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = 1e-6            # kernel vs plain version, max abs histogram error
TIME_ITERS = 100
QUERY_FRAMES = 9000   # 5 minutes of 30-fps video
QUERY_SEED = 7


def phase(name: str) -> None:
    print(f"\n=== {name} ===", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# phase 3 inputs                                                              #
# --------------------------------------------------------------------------- #
def all_rgb(seed: int) -> np.ndarray:
    """Every integer RGB triple once, in a seeded order: (2^24, 3) float32."""
    idx = np.random.default_rng(seed).permutation(1 << 24)
    return np.stack([idx >> 16, (idx >> 8) & 255, idx & 255],
                    axis=-1).astype(np.float32)


def edge_pixels(ref) -> np.ndarray:
    """Hand-made pixels on the places where one ulp moves a bucket, plus
    integer pixels whose H, S or V lands exactly on a range bound."""
    hand = [
        (255, 0, 10), (200, 50, 120), (100, 0, 99), (255, 0, 255),  # red-max, b > g
        (0, 0, 0), (45, 45, 45), (46, 46, 46), (128, 128, 128),     # greys, s = 0
        (200, 200, 200), (201, 201, 201), (255, 255, 255),
        (45, 20, 20), (46, 20, 20), (45, 45, 20), (46, 46, 20),     # v = 45 / 46
    ]
    cand = np.random.default_rng(11).integers(0, 256, (1 << 20, 3))
    cand = cand.astype(np.float32)
    hsv = ref.rgb_to_hsv(torch.from_numpy(cand)).numpy()
    h, s, v = hsv[:, 0], hsv[:, 1], hsv[:, 2]
    on_bound = (np.isin(h, [9, 10, 20, 33, 34, 85, 86, 128, 129, 158, 159, 177])
                | np.isin(s, [49, 50, 201]) | np.isin(v, [45, 46, 69, 70, 200, 201]))
    found = cand[on_bound]
    for name, arr, vals in (("h", h, (9, 10, 33, 34)), ("s", s, (49, 50, 201)),
                            ("v", v, (45, 46))):
        print(f"  edge set: {name} in {vals}: "
              f"{int(np.isin(arr, vals).sum())} pixels", flush=True)
    return np.concatenate([np.asarray(hand, np.float32), found])


def check_kernel(hsv_color, ref, ranges, crops: np.ndarray, label: str) -> float:
    x = torch.from_numpy(np.ascontiguousarray(crops)).cuda()
    got = hsv_color.hsv_color_hist(x, ranges)
    want = ref.hsv_color_classify(x, ranges)[0]
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    same_label = torch.equal(torch.argmax(got, -1), torch.argmax(want, -1))
    print(f"  {label}: shape {tuple(crops.shape)} max_abs_err {err!r} "
          f"argmax equal {same_label}", flush=True)
    if not (err <= TOL and same_label):
        raise AssertionError(f"hsv_color kernel disagrees on {label}: "
                             f"err {err!r}, argmax equal {same_label}")
    return err


def hsv_bound_ms(hw, rooflines, b: int, h: int, w: int, c: int):
    """(bound_ms, bound_by): bytes each read or written once over the
    memory rate, against the flops of the cost model over the f32 rate."""
    nbytes = b * h * w * 3 * 4 + c * 6 * 4 + b * (c + 1) * 4
    flops = b * rooflines.hsv_color(h, w, c).flops_per_row
    t_bytes, t_ops = nbytes / hw.HBM_BW * 1e3, flops / hw.PEAK_FLOPS_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_hsv(built, hsv_color, ref, hw, rooflines, ranges, b: int) -> dict:
    """Times of the hsv_color kernel on b 64x64 integer crops: through its
    wrapper (``ms``, what a caller pays), from its C entry point in a tight
    loop (``entry_ms``, the device time while the host keeps ahead), and of
    the plain version (``plain_ms``), beside the bound."""
    c = ranges.shape[0]
    x = torch.from_numpy(np.random.default_rng(b).integers(
        0, 256, (b, 64, 64, 3)).astype(np.float32)).cuda()
    out = torch.empty((b, c + 1), device="cuda")
    args = (x.data_ptr(), ranges.data_ptr(), out.data_ptr(), b, 64 * 64, c,
            torch.cuda.current_stream().cuda_stream)
    assert built.lib.hsv_color_hist(*args) == 0
    k_ms = time_ms(lambda: hsv_color.hsv_color_hist(x, ranges), TIME_ITERS)
    e_ms = time_ms(lambda: built.lib.hsv_color_hist(*args), TIME_ITERS)
    p_ms = time_ms(lambda: ref.hsv_color_classify(x, ranges),
                   TIME_ITERS if b <= 32 else 10)
    bound, bound_by = hsv_bound_ms(hw, rooflines, b, 64, 64, c)
    print(f"  B={b} 64x64: kernel {k_ms!r} ms (entry point {e_ms!r} ms), "
          f"plain {p_ms!r} ms, bound {bound!r} ms ({bound_by}, "
          f"{b * 64 * 64 * 12} B of crops)", flush=True)
    return {"ms": k_ms, "entry_ms": e_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import AQPExecutor, CostDriven, make_batch
    from repro_torch.core.policies import EDDY_POLICIES
    from repro_torch.data.video import BREEDS, SyntheticVideo
    from repro_torch.examples.lost_dog_query import build_plan, dog_table
    from repro_torch.kernels import _build, hsv_color, launch, ref
    from repro_torch.roofline import hw
    from repro_torch.udfs import planted_detector, planted_predicate, rooflines

    # ------------------------------------------------------------- 1 setup
    phase("1 setup")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print("device:", torch.cuda.get_device_name(0),
          "count:", torch.cuda.device_count())
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    cutlass = "/usr/local/cutlass/include"
    print("cutlass headers:", "present" if os.path.isdir(cutlass) else "absent")

    # ------------------------------------------------------------- 2 build
    phase("2 build")
    built = _build.load("hsv_color")
    print(f"  hsv_color: {built.path.name} built in {built.seconds:.2f}s")
    for line in built.log.splitlines():
        if "ptxas" in line:
            print("   ", line.strip())

    # ------------------------------------------------------------- 3 kernels
    phase("3 kernels against the plain version")
    ranges = torch.as_tensor(ref.COLOR_RANGES, device="cuda")
    c = ranges.shape[0]
    rng = np.random.default_rng(0)
    every = all_rgb(seed=1)
    cases = [
        ("all 2^24 integer RGB as 4096x64x64", every.reshape(4096, 64, 64, 3)),
        ("integer RGB 1024x96x96",
         rng.integers(0, 256, (1024, 96, 96, 3)).astype(np.float32)),
        ("float RGB 512x64x64",
         rng.uniform(0, 255, (512, 64, 64, 3)).astype(np.float32)),
        ("edge pixels, one per 1x1 crop", edge_pixels(ref).reshape(-1, 1, 1, 3)),
        ("all 2^24 integer RGB, one per 1x1 crop", every.reshape(-1, 1, 1, 3)),
        ("B=1 64x64", rng.integers(0, 256, (1, 64, 64, 3)).astype(np.float32)),
        *((f"main-path batch B={b} 64x64",
           rng.integers(0, 256, (b, 64, 64, 3)).astype(np.float32))
          for b in (2, 4, 8, 16, 32)),
        ("40x24 crops (H not a multiple of 64)",
         rng.integers(0, 256, (64, 40, 24, 3)).astype(np.float32)),
    ]
    max_err = 0.0
    for label, crops in cases:
        max_err = max(max_err, check_kernel(hsv_color, ref, ranges, crops, label))
    del every, cases
    empty = hsv_color.hsv_color_hist(torch.zeros((0, 64, 64, 3), device="cuda"),
                                     ranges)
    assert tuple(empty.shape) == (0, c + 1)

    timings = {b: time_hsv(built, hsv_color, ref, hw, rooflines, ranges, b)
               for b in (16, 32, 4096)}

    # ------------------------------------------------------------- 4 query
    phase(f"4 lost-dog query, SyntheticVideo({QUERY_FRAMES}, seed={QUERY_SEED})")
    t0 = time.perf_counter()
    video = SyntheticVideo(num_frames=QUERY_FRAMES, seed=QUERY_SEED)
    table = dog_table(video)
    n_dogs = len(table["_row_id"])
    print(f"  {n_dogs} dog crops, {table['crop'].nbytes / 1e6:.1f} MB float32, "
          f"built in {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    labels = np.concatenate([
        ref.hsv_color_classify(torch.from_numpy(table["crop"][i:i + 256]))[1]
        .numpy() for i in range(0, n_dogs, 256)])
    black = ref.COLOR_NAMES.index("black")
    expect = set(np.nonzero((labels == black) & (
        table["breed_gt"] == BREEDS.index("great dane")))[0].tolist())
    print(f"  plain version on the CPU: {len(expect)} rows expected "
          f"({time.perf_counter() - t0:.2f}s)")
    assert expect, "planted data guarantees matches"

    query = {}
    board_launches = 0
    main_sizes = collections.Counter()   # rows of each hooked launch
    hsv_color.launches = 0
    for policy in sorted(EDDY_POLICIES):
        q, plan = build_plan(table, policy=policy, device="cuda", max_workers=4)
        events = []   # hooked (color predicate) launches of this run
        hook = launch.add_launch_hook(events.append)
        t0 = time.perf_counter()
        try:
            rows = plan.collect_rows()
        finally:
            wall = time.perf_counter() - t0
            launch.remove_launch_hook(hook)
        main_sizes.update(e.rows for e in events)
        hooked_s = sum(e.seconds for e in events)
        got = set(rows["_row_id"].tolist())
        snap = plan.executor.stats_snapshot()
        entry = snap.get("hsv_color")
        if got != expect:
            raise AssertionError(
                f"policy {policy}: {len(got)} rows, expected {len(expect)}; "
                f"missing {sorted(expect - got)[:10]} extra {sorted(got - expect)[:10]}")
        if entry is None or entry["batches"] <= 0:
            raise AssertionError(f"policy {policy}: no hsv_color board entry")
        board_launches += int(entry["batches"])
        query[policy] = {
            "wall_s": wall, "rows": len(got),
            "board_launches": int(entry["batches"]),
            "hooked_launch_s": hooked_s,
            "hsv_color_cost_per_row_ms": entry["cost_per_row"] * 1e3,
            "pred_cost_per_row_ms": {
                p.name: snap[p.name]["cost_per_row"] * 1e3
                for p in q.predicates},
        }
        print(f"  {policy}: {len(got)} rows in {wall!r} s; hsv_color board "
              f"launches {int(entry['batches'])} taking {hooked_s!r} s "
              f"(launch to stream sync), cost/row "
              f"{entry['cost_per_row'] * 1e3!r} ms", flush=True)
    main_launches = hsv_color.launches
    print(f"  kernel launches {main_launches}, board launches {board_launches}"
          f", hooked launch sizes {dict(sorted(main_sizes.items()))}")
    if not (main_launches > 0 and main_launches >= board_launches):
        raise AssertionError("the query did not go through the hsv_color kernel")
    main_b = main_sizes.most_common(1)[0][0]
    if main_b not in timings:
        timings[main_b] = time_hsv(built, hsv_color, ref, hw, rooflines,
                                   ranges, main_b)

    # ------------------------------------------------------------- 5 detector
    phase("5 planted detectors with adaptive coalescing")
    drng = np.random.default_rng(5)
    n_rows, per = 2048, 16
    planted = drng.random(n_rows) < 0.5
    passing = set(np.nonzero(drng.random(n_rows) < 0.6)[0].tolist())
    frames = drng.integers(0, 256, (n_rows, 96, 96, 3)).astype(np.float32)
    batches = [make_batch({"rid": np.arange(i, i + per),
                           "frame": frames[i:i + per]},
                          row_ids=np.arange(i, i + per))
               for i in range(0, n_rows, per)]
    det = planted_detector("detector", planted, work_dim=96, device="cuda",
                           resource="cuda:0")
    keep = planted_predicate("planted", passing, cost_per_row=1e-6,
                             resource="cpu")
    sizes = []
    hsv_color.launches = 0
    hook = launch.add_launch_hook(lambda e: sizes.append(e.rows))
    try:
        ex = AQPExecutor([det, keep], policy=CostDriven(), max_workers=1,
                         warmup=False, coalesce="adaptive")
        t0 = time.perf_counter()
        got = {int(r) for b in ex.collect(iter(batches)) for r in b.row_ids}
        wall = time.perf_counter() - t0
    finally:
        launch.remove_launch_hook(hook)
    det_launches = hsv_color.launches
    want = {i for i in range(n_rows) if planted[i] and i in passing}
    snap = ex.stats_snapshot()["detector"]
    print(f"  {len(got)} rows in {wall!r} s; kernel launches {det_launches}; "
          f"fused launches {snap['fused_launches']}; launch sizes "
          f"{sorted(set(sizes))}")
    if got != want:
        raise AssertionError(f"detector path: {len(got)} rows, want {len(want)}")
    if det_launches <= 0:
        raise AssertionError("the detector path did not launch the kernel")

    # ------------------------------------------------------------- 6 lines
    phase("6 summary")
    summary = {
        "card": card, "query": query, "query_frames": QUERY_FRAMES,
        "dog_crops": n_dogs, "expected_rows": len(expect),
        "main_launch_sizes": dict(sorted(main_sizes.items())),
        "detector": {"rows": len(got), "wall_s": wall,
                     "launches": det_launches, "sizes": sorted(set(sizes))},
        "timings": {str(b): t for b, t in timings.items()},
    }
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    kernels = [{
        "name": "hsv_color", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hsv_color.cu",
        "replaces": "src/repro/kernels/hsv_color.py:64",
        "launches": main_launches, "max_abs_err": max_err,
        "batch": main_b, **timings[main_b],
        "by_batch": {str(b): t for b, t in sorted(timings.items())},
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
