"""Chip smoke test of the PyTorch port: build, check and time its kernels
on one CUDA card, then drive the UC1 lost-dog query, the review-triage
text query, the kernel predicates, the multi-tenant query service, the
LLM predicate, the ssm, hybrid, encdec and moe model families, the dense
decoder's training (with UC4's fine-tuned probe), the encdec, hybrid,
ssm and moe families' training, the on-device cascade filter and the
UC2 + UC3 warehouse-safety example through them, and the dry run.

    python3 chip_smoke.py [--before DIR]

Needs a CUDA card and nvcc; exits non-zero without them, and on any
failed phase. ``--before DIR`` (a checkout of an earlier commit, e.g. a
``git archive`` of it unpacked) also builds DIR's SSD forward (``ssd.cu``),
flash forward (``flash_attention.cu``), RG-LRU forward (``rglru.cu``) and
three gradient kernels (``flash_attention_bwd.cu``, ``rglru_bwd.cu`` and
``ssd_bwd.cu``) and times them beside these in phases 3 and 9
(``before_ms``; the RG-LRU forward's path on the model's bf16 tensors in
alternating pairs), the SSD forward's P = N = 4 instance, the SSD
gradient, the flash forward's float32 instances, the RG-LRU forward's
float32 instance and token entry and the RG-LRU gradient held bit-equal
to DIR's. Phases, in order:

1. setup   — card name and power limit, torch/CUDA/nvcc versions;
2. build   — compile every kernel from the sources in the checkout (and
             an empty kernel, the launch floor, three broken copies of
             the flash source, FLASH_MUTANTS, its tick probe, two of the
             flash gradient's,
             FLASH_BWD_MUTANTS, one each of the SSD forward's and
             gradient's, SSD_FWD_MUTANTS and SSD_BWD_MUTANTS, ssd.cu
             without its P = N = 4 instance, and --before's), one nvcc per
             source, all at once;
3. kernels — each kernel against its plain PyTorch version on the card
             (rglru and the router's logits bit for bit, through both entry
             points of each), then timed with CUDA events through its
             wrapper and at its C entry point beside its bound, the launch
             floor (and, for the attention kernels, beside
             scaled_dot_product_attention; for ssd, its P = N = 4 instance
             beside its three stages); then ssd, rglru, flash and the router
             at the shapes the model families of phases 10 and 11 give
             them (mamba2's scan with and without h0, a rerun's bits, a
             copy with one TF32 product instead of three, SSD_FWD_MUTANTS,
             refused, timed beside its 3xTF32 bound and --before's source,
             each of its three kernels' device time, TF32 HMMA counted in
             its SASS; rglru at recurrentgemma's forward (1, 2560,
             4096), train step (2, 2560, 4096, the float32 h sequence kept,
             with and without h0) and decode step (1, 1, 4096, a bf16
             state) on the model's bf16 tensors: bit-equal to ref.rglru,
             to the float32 instance cast and on a rerun, the design
             rglru.route picks, timed through the wrapper and at both
             entry points beside the bytes bound and the terms' issue
             floor counted in the SASS, and each design in a CUDA graph
             at the route's boundary shapes (RGLRU_ROUTE_SHAPES);
             recurrentgemma's local attention, whisper's encoder and
             cross-attention, grok-1's and arctic's attention in bf16 and
             grok-1's in float32, the router at (T, E, k) = (1024, 8, 2)
             and (1024, 128, 2) with tied rows, indices exact); bf16
             flash is held to ref.flash_bf16_limit, a limit of a few bf16
             ulps, which must refuse the three flash mutants (each a
             place of its shared kernel broken), takes a wgmma design fed
             by TMA (flash_attention_route) and gives the same bits on a
             rerun, at every shape it is timed at, where both bf16
             designs (a CTA a query tile; shared stages) are timed beside
             it and the call holds the bits of its route's design; its
             HGMMA are counted in each bf16 instance's SASS, the shared
             instances' spills (none) in ptxas' lines; the tick probe (a build with -DFLASH_PROBE)
             splits a CTA's chain at the LLM's and whisper's encoder
             shapes for both bf16 designs; then the flash
             gradient kernel through the autograd function against
             ref.flash_attention_bwd (FLASH_BWD_CASES, bf16 and float32:
             SmolLM-135M's training attention, a 4096-long windowed one,
             GQA groups 1 and 4, non-causal Sq != Sk, ragged S,
             whisper-small's encoder, decoder and cross attention as
             phase 13 trains them, and D = 256: recurrentgemma-9b's local
             attention at (2, 2560) and a non-causal case; the same bits
             on a rerun; bf16 on the wgmma instances fed by TMA, float32
             on the mma.sync ones), bf16 held to
             ref.flash_bwd_bf16_limits, which must refuse both gradient
             mutants, float32 to BWD_F32_RTOL and BWD_F32_ATOL; the
             gradient timed through its wrapper and entry point (bf16
             also in a CUDA graph, and beside --before's) beside its bound
             and SDPA's backward (the window as a boolean mask), and the
             forward with and without its LSE; then the RG-LRU gradient
             kernel at recurrentgemma-9b's training shape (2, 2560, 4096),
             with and without h0 and a cotangent of h_last, against
             ref.rglru_bwd within TOL_TIGHT, the same bits on a rerun, its
             bf16 instance bit-equal to the float32 one cast to bf16,
             timed as the main path calls it (bf16 in and out, straight
             through the bf16 instance), at its bf16 and float32 entry
             points (and beside --before's path), each beside its bound,
             and the plain version; then the SSD gradient kernel
             (SSD_BWD_CASES: mamba2-370m's training shape, the predicate's
             P = N = 4, and G = 2 with an h0, a cotangent of h_last and
             strided views) against ref.ssd_bwd, every gradient within
             1e-4 |want| + 1e-5 max |want| (scaled_share) and no worse
             against a float64 evaluation than the float32 plain version
             (twice its share, or 0.1), the same bits on a rerun, a copy
             with one TF32 product instead of three and one whose
             partials of dB and dC keep only a CTA's last head
             (SSD_BWD_MUTANTS)
             refused by that rule, timed through its wrapper and entry
             point (and beside --before's, each stage's device time
             beside it) beside its bound (3xTF32, and
             the float32 CUDA cores) and the plain versions (autograd
             through ref.ssd, ref.ssd_bwd), and its library's tensor-core
             instructions counted by kernel in cuobjdump's SASS (TF32
             HMMA in the chunk-state and per-chunk kernels, no F32
             atomics); then the router's gradient kernel at grok-1's and
             arctic-480b's (T, E, k) with tied rows against
             ref.moe_router_bwd (TOL_TIGHT, 0 at the experts not chosen,
             the same bits on a rerun), timed beside its bound;
4. query   — the lost-dog query (5 minutes of 30-fps video) on the card
             under every eddy policy; row ids against the plain version
             on the CPU, launches on the kernel counter and the board;
5. detector — planted detectors with adaptive coalescing (fused launches
             of varying batch size) against the planted expectation;
6. triage  — the review-triage query (MoERouter = expert 0 AND SSDScorer >
             0 AND rating <= 2) over 50,000 reviews under every eddy policy;
             row ids against the whole-table oracle through the kernels and
             through the plain versions, launches on the counters and the
             board; the router and RG-LRU predicates' calls (one launch
             through the token entries) against the parent's featurizer
             path: torch operations and host time a call;
7. registry — each text and attention kernel's predicate from
             ``build_predicate`` in an executor over the same rows, against
             its whole-table oracle;
8. service — the port's QueryService serving the triage, attention and
             decode queries at once over the first 20,000 of those
             reviews, each tenant against its oracle;
9. llm     — the LLM(...) predicate at SmolLM-135M's full width in bf16
             (30 layers, random weights from a seed): one forward at (10,
             512) through the flash kernel (30 launches) against the same
             forward with the plain attention, prefill and greedy decode
             against full forwards, the serving CLI's query over 5,000
             reviews on a QueryService under every eddy policy against a
             whole-table oracle scored through the kernel and through the
             plain attention, and the call's times: at 10 and 64 rows, its
             device time by kernel (torch.profiler), and the flash kernel at
             its shapes beside its bound and scaled_dot_product_attention;
10. families — mamba2-370m, recurrentgemma-9b and whisper-small at their
             configs' full width and depth in bf16 (random weights from a
             seed), one at a time: a forward through the kernels (48 ssd;
             26 rglru and 12 flash; 36 flash) against the same forward
             through their plain versions, beside a control (the plain
             versions against themselves with every output changed by
             3e-6), a prefill and decode steps (26 rglru and 12 flash
             launches a step for the last two) against full forwards,
             then a forward's and a decode step's times and a
             torch.profiler split of one forward (recurrentgemma's: each
             rglru_bsw call one RG-LRU kernel and no copy or cast in its
             profiler range). The logits are held to
             TOL_BF16 in bf16 for whisper-small, and in float32 (the same
             checks on the same model in float32) for the other two,
             whose bf16 control alone exceeds TOL_BF16;
11. moe    — grok-1-314b and arctic-480b at their configs' full width,
             cut in depth to what one card's 80 GB holds (6 of 64 and 2 of
             35 layers), in bf16 (random weights from a seed), one at a
             time: a forward at (2, 512) through the flash and router
             kernels (6 + 6; 2 + 2 launches) against the same forward
             through their plain versions, beside the control, with the
             share of routing assignments that agree and the drops by
             capacity; a prefill (2, 64) and decode steps (6; 2 router
             launches a step) against the same through the plain
             versions; times and a torch.profiler split of one forward.
             The logits are held to TOL_BF16 in float32, on the same
             draws cut to 2 and 1 layers: in bf16 a flipped expert choice
             moves a token's logits past it;
12. train  — TRAIN_FAMILIES' first: launch.train.train_loop on
             smollm-135m at full width and depth (30 layers, random
             weights from a seed), 40 steps of 8 x 512, as phase 13 runs
             each family (each step launches the flash forward 30 times,
             its recompute 30 and its gradient 30; the float32 gate on 2
             layers); then a crash at step 25 with checkpoints every 10,
             resumed to the same final loss; then UC4
             (examples.review_analytics) at its defaults, its rows against
             its whole-table oracle under every eddy policy;
13. train families — the others of TRAIN_FAMILIES, each as phase 12's:
             whisper-small at full width and depth (12 + 12 layers, 1,500
             frames; 40 steps of 4 x 448 through build's step, frames
             from a seeded torch.Generator), recurrentgemma-9b at full
             width cut to 4 of 38 layers (a group and a remainder block;
             20 steps of 2 x 2560 through train_loop) and mamba2-370m at
             full width and depth (48 layers; 8 steps of 4 x 512 through
             train_loop), bf16, remat=True, AdamW as build makes it: the
             loss falls, each step's launches exact (whisper 72 flash
             forward and 36 gradient calls; recurrentgemma 6 rglru
             forward, 3 rglru gradient, 2 flash forward and 1 flash
             gradient calls; mamba2 96 ssd forward and 48 ssd gradient
             calls), the peak memory; a float32 gate on the same draws cut
             (2 + 2 layers; one group at (1, 2560); 2 layers): gradients
             and a step through the kernels against the plain versions;
             two steps run twice to the same parameter bits; a step's
             time, tokens/s and torch.profiler split (recurrentgemma's:
             each rglru_bsw call, forward and recompute, one RG-LRU kernel
             and no copy or cast);
14. cascade — core.vectorized.cascade_filter over phase 6's kept rows:
             the router's token entry on the whole table, the SSD scan on
             compacted buckets of its survivors (the zero sentinel row
             padding the last); the mask equals phase 6's oracle;
15. warehouse — UC2 + UC3 (examples.warehouse_safety, 400 frames) on the
             CPU and on the card: Q3's unsafe frames under the
             cost-driven and reuse-aware policies equal the ground truth
             and the CPU run's, hsv_color launches on the board, cache
             hits under reuse-aware;
16. mesh — a world of one NCCL rank started in the process (a HashStore,
             no environment) and make_host_mesh()'s (1, 1) mesh on it:
             smollm-135m as phase 12 builds it (bf16, remat, AdamW),
             MESH_STEPS steps of 8 x 512 off the mesh and the same steps
             from the same draws and batches through build(cfg, mesh)
             (TRAIN_RULES, DTensor parameters and state); every loss and
             every parameter bit-equal, each step's launches exact (60
             flash forward, 30 gradient), the step's ms on and off
             (median, CUDA events) and a traced step's busy share each;
             then one forward of each of MESH_FORWARDS (mamba2-370m,
             recurrentgemma-9b, whisper-small, grok-1-314b at 6 layers)
             off the mesh and under SERVE_RULES on it, the same storage
             wrapped as DTensors (no bytes allocated): logits bit-equal,
             launches exact; the process group destroyed at the end;
17. moe train — the dry run of MOE_TRAIN's step and of arctic-480b's
             one layer on a (1, 1) fake mesh, in a subprocess; then
             grok-1-314b at full width, 1 of 64 layers, bf16, remat, 4
             steps of 2 x 512 under choose_optimizer(the whole model)
             (Adafactor) on build's schedule: launches exact (flash and router, forward,
             recompute and gradient), a falling loss, the peak memory at
             most 1 / PREDICTION_FLOOR of the dry run's bytes; a step's
             times, tokens/s and torch.profiler split; grok-1 reduced in
             float32 through the kernels against the plain versions
             (gradients and an Adafactor step); arctic-480b reduced with
             128 experts through build's step;
18. dry run — python -m repro_torch.launch.dryrun for smollm-135m
             train_4k on the (16, 16) single-pod mesh with --roofline in a
             subprocess (a fake world of 256 ranks): an ok record with
             FLOPs, a gradient reduction and temporaries, its terms;
19. the ``{"kernels": [...]}`` line, then the device line last.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = 1e-6            # kernel vs plain version, max abs histogram error
TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)  # text kernels vs plain versions
SCORE_ATOL = 1e-8     # SSD scores at the library shapes, kernel vs plain
TOL_BF16 = dict(rtol=8e-2, atol=8e-2)  # bfloat16 attention (tests/test_kernels.py)
ATT_SCORE_ATOL = 1e-7  # attention scores at the library shapes, kernel vs plain
TIME_ITERS = 100
QUERY_FRAMES = 9000   # 5 minutes of 30-fps video
QUERY_SEED = 7
TRIAGE_REVIEWS = 50_000
SERVICE_REVIEWS = 20_000  # the first reviews of the same table, for phase 8
SEQ = 64              # the text predicates' token window
VOCAB = 256           # the text predicates' embedding tables' rows
ATT_SEQ = 32          # the attention predicates' token window
BUCKETS = (1, 2, 4, 8, 16, 32)  # the executor's bucketed batch sizes
BIG = 4096            # rows for the throughput case
KERNELS = ("hsv_color", "moe_router", "ssd", "ssd_bwd", "rglru", "rglru_bwd",
           "flash_attention", "flash_attention_bwd", "decode_attention")
LIBRARIES = (*KERNELS, "empty")   # empty: the launch floor, not a TPU kernel
# bench_kernels' shapes: flash (B, S, H, Hkv, D, window), causal; decode
# (B, S, H, Hkv, D) with full lengths
FLASH_BENCH = ((1, 1024, 8, 2, 64, 0), (2, 2048, 8, 2, 64, 0),
               (1, 4096, 4, 1, 64, 512))
DECODE_BENCH = (8, 4096, 8, 2, 64)
LLM_ARCH = "smollm-135m"  # the LLM predicate's model, at its published widths
LLM_SEED = 0
LLM_REVIEWS = 5000        # the LLM query's table
LLM_ROWS = 10             # the serving CLI's routing batch
LLM_ORACLE_ROWS = 64      # the whole-table oracle's batch
LLM_PROMPT, LLM_STEPS = 64, 8   # prefill length, greedy decode steps
LLM_MARGIN = 4            # the row gate's margin, in units of the largest
                          # score difference between batches of 10 and 64
LLM_ROUNDS = 7            # timed LLM calls, of which the median is kept


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


def graph_ms(call, n: int = 100, reps: int = 20) -> float:
    """Milliseconds a launch of ``call(stream)`` (a C entry point) takes
    when n launches are replayed as one CUDA graph: the device time with
    no host work between launches, which the tight loops of ``time_ms``
    cannot show for kernels shorter than a launch's host cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            call(side.cuda_stream)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(n):
            call(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * reps)


def paired_times(fns: dict, rounds: int = 5,
                 iters: int = TIME_ITERS) -> dict:
    """``time_ms`` of each call in each of ``rounds`` rounds that take the
    calls in turn, reversing the order every round, so that host noise
    (these calls are host-bound at small batches) falls on all of them."""
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(time_ms(fns[name], iters))
    return times


def paired_ms(fns: dict, rounds: int = 5, iters: int = TIME_ITERS) -> dict:
    """Median of each call's ``paired_times``."""
    return {name: float(np.median(t))
            for name, t in paired_times(fns, rounds, iters).items()}


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


def time_hsv(hsv_color, ref, hw, rooflines, ranges, b: int) -> dict:
    """Times of the hsv_color kernel on b 64x64 integer crops: through its
    wrapper (``ms``, what a caller pays) and from its C entry point
    (``entry_ms``, the device time while the host keeps ahead), taken in
    turns (``paired_ms``), and of the plain version (``plain_ms``), beside
    the bound."""
    from repro_torch.kernels import _build
    c = ranges.shape[0]
    x = torch.from_numpy(np.random.default_rng(b).integers(
        0, 256, (b, 64, 64, 3)).astype(np.float32)).cuda()
    out = torch.empty((b, c + 1), device="cuda")
    call = _build.load("hsv_color").lib.hsv_color_hist
    args = hsv_color.pack_args(x, ranges, out, b, 64 * 64, c)
    stream = torch.cuda.current_stream().cuda_stream
    assert call(args, stream) == 0
    t = paired_ms({"ms": lambda: hsv_color.hsv_color_hist(x, ranges),
                   "entry_ms": lambda: call(args, stream)})
    t["graph_ms"] = graph_ms(lambda st: call(args, st))
    p_ms = time_ms(lambda: ref.hsv_color_classify(x, ranges),
                   TIME_ITERS if b <= 32 else 10)
    bound, bound_by = hsv_bound_ms(hw, rooflines, b, 64, 64, c)
    plan = hsv_color.plan(b, 64 * 64)
    print(f"  B={b} 64x64: kernel {t['ms']!r} ms (entry point "
          f"{t['entry_ms']!r} ms, in a graph {t['graph_ms']!r} ms), plain "
          f"{p_ms!r} ms, bound {bound!r} ms "
          f"({bound_by}, {b * 64 * 64 * 12} B of crops); {plan}", flush=True)
    return {**t, "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None}


def launch_floor_ms() -> dict:
    """One empty kernel (``csrc/empty.cu``) launched from its C entry point
    as the kernels' entry points are timed: in a tight loop (what a launch
    costs the host) and replayed in a graph (what it costs the card)."""
    from repro_torch.kernels import _build
    call = _build.load("empty").lib.empty_launch
    stream = torch.cuda.current_stream().cuda_stream
    if call(stream) != 0:
        raise AssertionError("empty kernel launch failed")
    t = {"entry_ms": time_ms(lambda: call(stream), 10 * TIME_ITERS),
         "graph_ms": graph_ms(call)}
    print(f"  empty kernel: {t['entry_ms']!r} ms a launch from its entry "
          f"point, {t['graph_ms']!r} ms in a graph (the launch floor)",
          flush=True)
    return t


# --------------------------------------------------------------------------- #
# phase 3: the text kernels against their plain versions                      #
# --------------------------------------------------------------------------- #
def within(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float):
    """(max abs error, whether every element is within atol + rtol*|want|)."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not got.numel():
        return 0.0, True
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return float(err.max()), ok


def check_router(logits: torch.Tensor, k: int, label: str,
                 expect_idx=None) -> float:
    from repro_torch.kernels import moe_router, ref
    w, idx = moe_router.moe_router_tk(logits, k)
    w_p, idx_p = ref.moe_topk_router(logits, k)
    torch.cuda.synchronize()
    err, ok = within(w, w_p, **TOL_TIGHT)
    same = idx.dtype == torch.int32 and torch.equal(idx, idx_p)
    if expect_idx is not None:
        same = same and torch.equal(idx.cpu(), torch.as_tensor(expect_idx,
                                                               dtype=torch.int32))
    print(f"  moe_router {label}: logits {tuple(logits.shape)} k={k} "
          f"weights max_abs_err {err!r}, idx equal {same}", flush=True)
    if not (ok and same):
        raise AssertionError(f"moe_router kernel disagrees on {label}")
    return err


def check_ssd(x, dt, A, Bm, Cm, h0, chunk: int, label: str,
              score_atol: float | None = None) -> float:
    """x (B,S,H,P), dt (B,S,H), Bm/Cm (B,S,G,N): the model layout of
    ``ops.ssd``; the kernel gets them transposed, as ops does."""
    from repro_torch.kernels import ref, ssd
    from repro_torch.udfs.library import row_mean
    y, h_last = ssd.ssd_bhcp(x.transpose(1, 2), dt.transpose(1, 2), A,
                             Bm.transpose(1, 2), Cm.transpose(1, 2), h0,
                             chunk=chunk)
    y = y.transpose(1, 2)
    y_p, h_p = ref.ssd(x, dt, A, Bm, Cm, h0, chunk=chunk)
    torch.cuda.synchronize()
    err_y, ok_y = within(y, y_p, **TOL_TIGHT)
    err_h, ok_h = within(h_last, h_p, **TOL_TIGHT)
    ok, extra = ok_y and ok_h, ""
    if score_atol is not None:
        err_s, ok_s = within(row_mean(y), row_mean(y_p), 0.0, score_atol)
        ok, extra = ok and ok_s, f", score max_abs_err {err_s!r}"
    b, s, h, p = x.shape
    print(f"  ssd {label}: B={b} S={s} H={h} P={p} G={Bm.shape[2]} "
          f"N={Bm.shape[3]} chunk={chunk} y max_abs_err {err_y!r}, h_last "
          f"{err_h!r}{extra}", flush=True)
    if not ok:
        raise AssertionError(f"ssd kernel disagrees on {label}")
    return max(err_y, err_h)


def check_ssd_ops(x, dt, A, Bm, Cm, label: str) -> float:
    """``ops.ssd`` on the predicate's own views (ssd_inputs: a dt broadcast
    over heads, no h0) against the plain version: one launch, nothing
    allocated but y and h_last, scores within SCORE_ATOL."""
    from repro_torch.kernels import ops, ref, ssd
    from repro_torch.udfs.library import row_mean
    stats = torch.cuda.memory_stats
    before = (ssd.launches, stats()["allocation.all.allocated"])
    y, h_last = ops.ssd(x, dt, A, Bm, Cm, chunk=SEQ)
    launched = ssd.launches - before[0]
    allocated = stats()["allocation.all.allocated"] - before[1]
    y_p, h_p = ref.ssd(x, dt, A, Bm, Cm, None, chunk=SEQ)
    torch.cuda.synchronize()
    err_y, ok_y = within(y, y_p, **TOL_TIGHT)
    err_h, ok_h = within(h_last, h_p, **TOL_TIGHT)
    err_s, ok_s = within(row_mean(y), row_mean(y_p), 0.0, SCORE_ATOL)
    print(f"  ssd {label} through ops (dt stride {dt.stride()}, h0 None): "
          f"y max_abs_err {err_y!r}, h_last {err_h!r}, score {err_s!r}; "
          f"launches {launched}, allocations {allocated} (y and h_last)",
          flush=True)
    if not (ok_y and ok_h and ok_s and launched == 1 and allocated == 2):
        raise AssertionError(f"ssd through ops disagrees or copies on {label}")
    return max(err_y, err_h)


def bit_equal(got, want, label: str) -> float:
    """Raise unless every (got, want) pair is equal bit for bit; returns
    the largest absolute difference (0.0)."""
    err = max(within(g, w, 0.0, 0.0)[0] for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{label}: not bit-equal (max_abs_err {err!r})")
    return err


def check_rglru(x, r, i, a_param, h0, label: str) -> float:
    """``rglru_bsw`` against ``ref.rglru``: equal bit for bit."""
    from repro_torch.kernels import ref, rglru
    got = rglru.rglru_bsw(x, r, i, a_param, h0)
    want = ref.rglru(x, r, i, a_param, h0)
    torch.cuda.synchronize()
    err = bit_equal(got, want, f"rglru {label}")
    print(f"  rglru {label}: (B,S,W) {tuple(x.shape)} h0 "
          f"{'None' if h0 is None else 'given'}: out and h_last max_abs_err "
          f"{err!r} (bit-equal)", flush=True)
    return err


def check_rglru_tokens(toks, tables, a_param, h0, label: str) -> float:
    """``rglru_tokens`` against ``ref.rglru`` on the gathered rows, and
    ``rglru_bsw`` on the same rows: all equal bit for bit."""
    from repro_torch.kernels import ref, rglru
    got = rglru.rglru_tokens(toks, *tables, a_param, h0)
    t = toks.long()
    rows = [tab[t] for tab in tables]
    want = ref.rglru(*rows, a_param, h0)
    dense = rglru.rglru_bsw(*rows, a_param, h0)
    torch.cuda.synchronize()
    err = bit_equal((*got, *dense), (*want, *want), f"rglru_tokens {label}")
    print(f"  rglru_tokens {label}: toks {tuple(toks.shape)} tables "
          f"{tuple(tables[0].shape)} h0 {'None' if h0 is None else 'given'}: "
          f"out and h_last max_abs_err {err!r} (bit-equal, and to rglru_bsw "
          f"on the gathered rows)", flush=True)
    return err


def check_router_tokens(toks, emb, w_gate, k: int, label: str) -> float:
    """``moe_router_tokens`` against the plain path (``router_logits`` then
    ``ref.moe_topk_router``): logits bit-equal, idx equal, weights within
    TOL_TIGHT; and the weights bit-equal to ``moe_router_tk`` on the same
    logits (the two entries share the body)."""
    from repro_torch.kernels import moe_router, ref
    b, e = toks.shape[0], w_gate.shape[1]
    logits = torch.empty((b, e), device=toks.device)
    w, idx = moe_router.moe_router_tokens(toks, emb, w_gate, k, logits)
    want = ref.router_logits(emb, w_gate, toks)
    w_p, idx_p = ref.moe_topk_router(want, k)
    w_tk, idx_tk = moe_router.moe_router_tk(want, k)
    torch.cuda.synchronize()
    logits_eq = torch.equal(logits, want)
    same = torch.equal(idx, idx_p) and torch.equal(idx, idx_tk)
    same_tk = torch.equal(w, w_tk)
    err, ok = within(w, w_p, **TOL_TIGHT)
    print(f"  moe_router_tokens {label}: toks {tuple(toks.shape)} D="
          f"{emb.shape[1]} E={e} k={k}: logits bit-equal {logits_eq}, idx "
          f"equal {same}, weights max_abs_err {err!r} (bit-equal to "
          f"moe_router_tk: {same_tk})", flush=True)
    if not (logits_eq and same and same_tk and ok):
        raise AssertionError(f"moe_router_tokens disagrees on {label}")
    return err


class TextInputs:
    """The text predicates' own kernel inputs for the first rows of the
    kept review table, made on the card by the library's featurizer."""

    def __init__(self, toks_kept: np.ndarray):
        from repro_torch.udfs import library as lib
        dev = torch.device("cuda")
        self.toks = lib.token_ids(toks_kept[:BIG], SEQ, VOCAB, dev)  # int32
        self.router = lib.router_tables(device=dev)
        self.ssd = lib.ssd_tables(device=dev)
        self.rglru = lib.rglru_tables(device=dev)

    def logits(self, b: int) -> torch.Tensor:
        from repro_torch.kernels.ref import router_logits
        return router_logits(*self.router, self.toks[:b])

    def ssd_args(self, b: int):
        """(x, dt, A, Bm, Cm, h0) in the model layout, h0 zero."""
        from repro_torch.udfs.library import ssd_inputs
        x, dt, A, Bm, Cm = ssd_inputs(self.ssd, self.toks[:b])
        h0 = torch.zeros((b, x.shape[2], x.shape[3], Bm.shape[3]),
                         device=x.device)
        return x, dt, A, Bm, Cm, h0

    def rglru_args(self, b: int):
        """(x, r, i, a_param, h0), h0 zero."""
        emb_x, emb_r, emb_i, a_param = self.rglru
        t = self.toks[:b]
        return (emb_x[t], emb_r[t], emb_i[t], a_param,
                torch.zeros((b, a_param.shape[0]), device=t.device))


def check_text_kernels(inputs: TextInputs) -> dict:
    """Phase 3 for moe_router, ssd and rglru: the JAX package's test
    shapes, the library shapes at every bucketed batch and at BIG rows,
    and the edge cases. Returns each kernel's largest error."""
    rng = np.random.default_rng(12)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    err = {"moe_router": 0.0, "ssd": 0.0, "rglru": 0.0}
    # ---- moe_router
    for t, e, k in ((64, 8, 2), (128, 16, 2), (32, 4, 1)):
        err["moe_router"] = max(err["moe_router"], check_router(
            T(rng.standard_normal((t, e))), k, f"test shape T={t} E={e}"))
    for b in (*BUCKETS, BIG):
        err["moe_router"] = max(err["moe_router"], check_router(
            inputs.logits(b), 2, f"library B={b}"))
    ties = np.zeros((5, 8), np.float32)
    ties[1, [2, 5]] = 1.0
    ties[2, 3], ties[2, [1, 6]] = 2.0, 1.0
    ties[3, [0, 7]] = 3.0
    ties[4] = -5.0
    err["moe_router"] = max(err["moe_router"], check_router(
        T(ties), 2, "tied logits", expect_idx=[[0, 1], [2, 5], [3, 1], [0, 7],
                                               [0, 1]]))
    for e in (4, 8, 16):
        for t in (129, 1000):
            err["moe_router"] = max(err["moe_router"], check_router(
                T(rng.standard_normal((t, e))), 1, f"k=1 T={t} E={e}"))
    # the token entry: the predicate's own ids and tables, then other
    # windows, widths and expert counts on random tables (row 0 zero)
    for b in (*BUCKETS, 7, BIG):
        err["moe_router"] = max(err["moe_router"], check_router_tokens(
            inputs.toks[:b], *inputs.router, 2, f"library B={b}"))
    for b, seq, d, e, k in ((33, 100, 16, 8, 2), (33, 5, 7, 3, 3),
                            (33, 1, 12, 64, 1), (1000, 63, 16, 8, 2)):
        emb = T(rng.standard_normal((50, d)))
        emb[0] = 0.0
        toks = torch.from_numpy(rng.integers(0, 50, (b, seq)).astype(
            np.int32)).cuda()
        err["moe_router"] = max(err["moe_router"], check_router_tokens(
            toks, emb, T(rng.standard_normal((d, e))), k, "random tables"))

    # ---- ssd
    def ssd_case(b, s, h, p, g, n, chunk, label, h0_scale=0.0, dt_zero=()):
        x = T(rng.standard_normal((b, s, h, p)) * 0.5)
        dt = rng.uniform(0.01, 0.2, (b, s, h))
        for lo, hi in dt_zero:
            dt[:, lo:hi] = 0.0
        A = T(-rng.uniform(0.5, 2.0, (h,)))
        Bm = T(rng.standard_normal((b, s, g, n)) * 0.3)
        Cm = T(rng.standard_normal((b, s, g, n)) * 0.3)
        h0 = T(rng.standard_normal((b, h, p, n)) * h0_scale)
        return check_ssd(x, T(dt), A, Bm, Cm, h0, chunk, label)

    for args in ((1, 64, 2, 16, 1, 16, 16), (2, 128, 4, 32, 2, 16, 32),
                 (1, 128, 4, 64, 1, 32, 64)):
        err["ssd"] = max(err["ssd"], ssd_case(*args, "test shape"))
    err["ssd"] = max(err["ssd"], ssd_case(
        2, 128, 4, 32, 2, 16, 32, "G<H, nonzero h0", h0_scale=1.0))
    err["ssd"] = max(err["ssd"], ssd_case(
        3, 64, 2, 4, 1, 4, 16, "4 chunks, runs of dt=0, nonzero h0",
        h0_scale=1.0, dt_zero=((5, 30), (48, 64))))
    err["ssd"] = max(err["ssd"], ssd_case(
        2, 128, 4, 8, 2, 8, 32, "dt=0 across chunk edges, nonzero h0",
        h0_scale=1.0, dt_zero=((20, 70), (100, 128))))
    err["ssd"] = max(err["ssd"], ssd_case(
        2, 256, 2, 4, 1, 4, 64, "4 chunks of 64, nonzero h0", h0_scale=1.0))
    err["ssd"] = max(err["ssd"], ssd_case(
        2, 48, 2, 6, 1, 3, 24, "ragged P and N, nonzero h0", h0_scale=1.0))
    for b in (*BUCKETS, BIG):
        err["ssd"] = max(err["ssd"], check_ssd(
            *inputs.ssd_args(b), SEQ, f"library B={b}", score_atol=SCORE_ATOL))
        err["ssd"] = max(err["ssd"], check_ssd_ops(
            *inputs.ssd_args(b)[:5], f"library B={b}"))

    # ---- rglru
    for b, s, w in ((1, 64, 64), (2, 128, 128), (2, 96, 256), (4, 1, 16),
                    (4, 64, 16), (4, 96, 16)):
        x, r, i = (T(rng.standard_normal((b, s, w))) for _ in range(3))
        err["rglru"] = max(err["rglru"], check_rglru(
            x, r, i, T(rng.standard_normal(w)), T(rng.standard_normal((b, w))),
            "nonzero h0"))
    for b in (*BUCKETS, BIG):
        err["rglru"] = max(err["rglru"], check_rglru(
            *inputs.rglru_args(b), f"library B={b}"))
        x, r, i, a_param, _ = inputs.rglru_args(b)
        err["rglru"] = max(err["rglru"], check_rglru(
            x, r, i, a_param, None, f"library B={b}"))
    # the token entry: the predicate's own ids and tables (no h0, as the
    # predicate calls it, and a given one), then ragged shapes (W past a
    # tile of 32 and not a multiple of 4, S past a chunk of 32, S = 1, 0)
    for b in (*BUCKETS, 7, BIG):
        tables, a_param = inputs.rglru[:3], inputs.rglru[3]
        err["rglru"] = max(err["rglru"], check_rglru_tokens(
            inputs.toks[:b], tables, a_param, None, f"library B={b}"))
    err["rglru"] = max(err["rglru"], check_rglru_tokens(
        inputs.toks[:16], inputs.rglru[:3], inputs.rglru[3],
        T(rng.standard_normal((16, 16))), "library B=16, nonzero h0"))
    for b, s, w in ((3, 70, 40), (5, 33, 7), (2, 1, 16), (4, 0, 16),
                    (2, 96, 256)):
        tables = [T(rng.standard_normal((50, w))) for _ in range(3)]
        toks = torch.from_numpy(rng.integers(0, 50, (b, s)).astype(
            np.int32)).cuda()
        for h0 in (None, T(rng.standard_normal((b, w)))):
            err["rglru"] = max(err["rglru"], check_rglru_tokens(
                toks, tables, T(rng.standard_normal(w)), h0, "random tables"))
    return err


def bound_ms(nbytes: int, flops: float):
    """(bound_ms, bound_by): bytes over the memory rate against flops over
    the float32 rate, whichever is larger."""
    from repro_torch.roofline import hw
    t_bytes, t_ops = nbytes / hw.HBM_BW * 1e3, flops / hw.PEAK_FLOPS_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_core_bound(nbytes: int, flops: float, dtype: torch.dtype) -> dict:
    """The bound of a kernel whose products run on the tensor cores (the
    attention kernels, the SSD gradient): bytes over the memory rate
    against the products at the rate the kernel's precision allows
    (float32 as 3xTF32: three TF32 products each at 495 TFLOP/s; bf16 at
    989 TFLOP/s), whichever is larger; beside it the float32 CUDA-core
    time (67 TFLOP/s)."""
    from repro_torch.roofline import hw
    t_bytes = nbytes / hw.HBM_BW * 1e3
    t_ops = (flops / hw.PEAK_FLOPS_BF16 if dtype == torch.bfloat16
             else 3 * flops / hw.PEAK_FLOPS_TF32) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_f32_cores_ms": bound_ms(nbytes, flops)[0]}


def ssd_view_args(x, dt, A, Bm, Cm, y, h_last, chunk: int = SEQ) -> bytes:
    """The ssd entry point's packed arguments for a main path's call: the
    model's (B, S, H, P) views read through their strides, no h0."""
    from repro_torch.kernels import ssd
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    return ssd.ARGS.pack(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), 0, y.data_ptr(), h_last.data_ptr(),
        *(v for t in (x, dt, Bm, Cm, y) for v in t.stride()),
        b, h, s, p, g, n, chunk, 0)


# csrc/ssd.cu's dispatch of the P = N = 4 instance, and the line of
# csrc/ssd_stages.cuh's mma3 that adds the 3xTF32 split's two corrections
SSD_DISPATCH = "  if (a->p == 4 && a->n == 4) return launch_p4n4(*a, s);\n"
SSD_SPLIT_LINE = ("      mma_tf32(small[j], al, bh); mma_tf32(small[j], ah, bl);  "
                  "// the split's corrections\n")


def build_variant(name: str, line: str, new: str, path: str, entry: str,
                  header: str | None = None):
    """``entry`` of a copy of ``csrc/<name>.cu`` with its one ``line``
    replaced by ``new`` (or, given ``header``, a copy of that header of
    ``csrc/`` edited so, written beside the source's copy, where its
    #include finds it first), written to ``path`` (a .cu) and built beside
    it with the library's own flags."""
    from repro_torch.kernels import _build
    edited = header or f"{name}.cu"
    src = (_build.CSRC / edited).read_text()
    if src.count(line) != 1:
        raise AssertionError(f"{edited}: the line {line!r} is gone")
    code = src.replace(line, new)
    if header:
        with open(os.path.join(os.path.dirname(path), header), "w") as f:
            f.write(code)
        code = (_build.CSRC / f"{name}.cu").read_text()
    with open(path, "w") as f:
        f.write(code)
    lib_path = path[:-len(".cu")] + ".so"
    proc = subprocess.run([_build.nvcc_path(), *_build.flags(name), "-o",
                           lib_path, path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n"
                           f"{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(lib_path), entry)
    fn.argtypes, fn.restype = _build.SIGNATURES[name][entry]
    return fn


def build_ssd_stages():
    """The ssd entry point of a copy of ``csrc/ssd.cu`` whose dispatch
    leaves out the P = N = 4 instance, so every shape takes the three
    stages, for ``ssd_instances``."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return build_variant("ssd", SSD_DISPATCH, "",
                         str(_build.BUILD_DIR / "ssd_stages_only.cu"),
                         "ssd_scan")


def ssd_instances(inputs: TextInputs, stages, before=None) -> dict:
    """The ssd kernel's P = N = 4 instance against its three stages
    (``build_ssd_stages``) on the main path's call at B = 4 and BIG rows:
    each replayed in a CUDA graph (``graph_ms``), in the order p4n4,
    stages, stages, p4n4, and the largest difference of their y and
    h_last; given ``before`` (``build_before``'s), the P = N = 4
    instance's y and h_last bit-equal to the earlier source's."""
    from repro_torch.kernels import _build, ssd
    lib = _build.load("ssd").lib.ssd_scan
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for b in (4, BIG):
        x, dt, A, Bm, Cm, h0 = inputs.ssd_args(b)
        _, s, h, p = x.shape
        scratch = torch.empty(ssd.stage_floats(b, h, s, p, Bm.shape[3], SEQ),
                              device="cuda")
        calls = {"p4n4": lambda a, st: lib(a, None, st),
                 "stages": lambda a, st: stages(a, scratch.data_ptr(), st)}
        if before is not None:
            calls["before"] = lambda a, st: before["ssd"](a, None, st)
        res, times = {}, {name: [] for name in ("p4n4", "stages")}
        for name in calls:
            res[name] = (torch.empty_like(x), torch.empty_like(h0))
        args = {name: ssd_view_args(x, dt, A, Bm, Cm, *res[name])
                for name in calls}
        for name in ("p4n4", "stages", "stages", "p4n4"):
            call, a = calls[name], args[name]
            if call(a, stream) != 0:
                raise AssertionError(f"ssd {name} failed")
            times[name].append(graph_ms(lambda st: call(a, st)))
        torch.cuda.synchronize()
        diff = max(float((u - v).abs().max())
                   for u, v in zip(res["p4n4"], res["stages"]))
        out[str(b)] = {**{f"{name}_graph_ms": float(np.mean(t))
                          for name, t in times.items()},
                       "max_abs_diff": diff}
        extra = ""
        if before is not None:
            if calls["before"](args["before"], stream) != 0:
                raise AssertionError("the earlier ssd entry point failed")
            torch.cuda.synchronize()
            same = all(torch.equal(u, v)
                       for u, v in zip(res["p4n4"], res["before"]))
            out[str(b)]["p4n4_bit_equal_to_before"] = same
            extra = f"; P = N = 4 bit-equal to the earlier source's: {same}"
            if not same:
                raise AssertionError("the P = N = 4 instance's bits moved")
        print(f"  ssd instances B={b}: P = N = 4 "
              f"{out[str(b)]['p4n4_graph_ms']!r} ms, the stages "
              f"{out[str(b)]['stages_graph_ms']!r} ms in a graph; "
              f"outputs differ by {diff!r}{extra}", flush=True)
        if not diff <= TOL_TIGHT["atol"]:
            raise AssertionError("ssd instances disagree")
    return out


def time_text(inputs: TextInputs, b: int) -> dict:
    """Times of the three text kernels through their wrappers (``ms``) and
    from their C entry points (``entry_ms``), taken in turns
    (``paired_ms``), and of their plain versions, on the library's inputs
    for b rows, beside the bounds (each input read once, each output
    written once; flops of the cost model in ``udfs/rooflines.py``, the
    SSD's ``ssd.flops``). Each
    kernel's plain keys time the main path's own call: ``ssd_bshp`` on the
    predicate's views (ssd_inputs: a dt broadcast over heads, no h0), with
    ``ops_ms`` the same through ``ops.ssd``, and the token entries
    ``moe_router_tokens`` and ``rglru_tokens`` (no h0) on the predicates'
    int32 ids and tables. The ``bhcp_`` keys time ``ssd_bhcp`` on
    contiguous (B, H, S, P) copies with a zero h0, the ``tk_`` keys
    ``moe_router_tk`` on the featurizer's logits, the ``bsw_`` keys
    ``rglru_bsw`` on the gathered rows with a zero h0."""
    from repro_torch.kernels import _build, moe_router, ops, ref, rglru, ssd
    from repro_torch.udfs import rooflines
    iters = TIME_ITERS if b <= 32 else 10
    stream = torch.cuda.current_stream().cuda_stream

    graphs = {}

    def entry(name: str, fn: str, args: bytes, key: str | None = None):
        """The C entry point alone: the device time while the host keeps
        ahead of it (and, in ``graphs[key or name]``, replayed in a CUDA
        graph). ssd's takes no scratch at P = N = 4."""
        lib_call = getattr(_build.load(name).lib, fn)
        call = ((lambda a, st: lib_call(a, None, st)) if name == "ssd"
                else lib_call)
        if call(args, stream) != 0:
            raise AssertionError(f"{name} entry point failed")
        graphs[key or name] = graph_ms(lambda st: call(args, st))
        return lambda: call(args, stream)

    out = {}
    # moe_router: the main path's call, the token entry on the predicate's
    # ids and tables; moe_router_tk on their logits under the tk_ keys
    logits = inputs.logits(b)
    ids = inputs.toks[:b]
    emb, w_gate = inputs.router
    (v, d), e, k = emb.shape, w_gate.shape[1], 2
    w_out = torch.empty((b, k), device=logits.device)
    i_out = torch.empty((b, k), dtype=torch.int32, device=logits.device)
    out["moe_router"] = {
        **paired_ms({
            "ms": lambda: moe_router.moe_router_tokens(ids, emb, w_gate, k),
            "entry_ms": entry("moe_router", "moe_router_tokens",
                              moe_router.TOKENS_ARGS.pack(
                                  ids.data_ptr(), emb.data_ptr(),
                                  w_gate.data_ptr(), 0, w_out.data_ptr(),
                                  i_out.data_ptr(), b, SEQ, d, e, k, v)),
            "tk_ms": lambda: moe_router.moe_router_tk(logits, k),
            "tk_entry_ms": entry("moe_router", "moe_router_tk",
                                 moe_router.ARGS.pack(
                                     logits.data_ptr(), w_out.data_ptr(),
                                     i_out.data_ptr(), b, e, k, 0),
                                 "moe_router_tk")}),
        "plain_ms": time_ms(lambda: ref.moe_router_tokens(ids, emb, w_gate, k),
                            iters),
        "tk_plain_ms": time_ms(lambda: ref.moe_topk_router(logits, k), iters),
        # ids, the table and the gate read once, weights and idx written;
        # the featurizer's adds, divisions and gate products besides the
        # router's flops
        **dict(zip(("bound_ms", "bound_by"), bound_ms(
            4 * (b * SEQ + v * d + d * e + 2 * b * k),
            b * (SEQ * d + d + 2 * d * e
                 + rooflines.moe_router(e, k).flops_per_row)))),
        "tk_bound_ms": bound_ms(b * e * 4 + b * k * 8,
                                b * rooflines.moe_router(e, k).flops_per_row)[0],
    }
    # ssd: the main path's call, ssd_bshp on the predicate's own views (a
    # dt broadcast over heads, no h0), then ssd_bhcp on contiguous
    # (B, H, S, P) copies with a zero h0 under the bhcp_ keys
    x, dt, A, Bm, Cm, h0 = inputs.ssd_args(b)
    _, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    h_out = torch.empty_like(h0)
    y_out = torch.empty_like(x)   # held while the packed pointers are used
    main_args = ssd_view_args(x, dt, A, Bm, Cm, y_out, h_out)
    kx, kdt, kB, kC = (t.transpose(1, 2).contiguous() for t in (x, dt, Bm, Cm))
    ky_out = torch.empty_like(kx)
    strides = tuple(map(ssd.bhsp_strides, (kx, kdt, kB, kC, ky_out)))
    bhcp_args = ssd.ARGS.pack(
        kx.data_ptr(), kdt.data_ptr(), A.data_ptr(), kB.data_ptr(),
        kC.data_ptr(), h0.data_ptr(), ky_out.data_ptr(), h_out.data_ptr(),
        *(v for st in strides for v in st), b, h, s, p, g, n, SEQ, 0)
    out["ssd"] = {
        **paired_ms({
            "ms": lambda: ssd.ssd_bshp(x, dt, A, Bm, Cm, chunk=SEQ),
            "entry_ms": entry("ssd", "ssd_scan", main_args),
            "ops_ms": lambda: ops.ssd(x, dt, A, Bm, Cm, chunk=SEQ),
            "bhcp_ms": lambda: ssd.ssd_bhcp(kx, kdt, A, kB, kC, h0, chunk=SEQ),
            "bhcp_entry_ms": entry("ssd", "ssd_scan", bhcp_args, "ssd_bhcp")}),
        "plain_ms": time_ms(lambda: ref.ssd(x, dt, A, Bm, Cm, None, chunk=SEQ),
                            iters),
        # x and y, dt once a token (stride 0 over heads), A, Bm, Cm, h_last
        **dict(zip(("bound_ms", "bound_by"), bound_ms(
            4 * (2 * b * s * h * p + b * s + h + 2 * b * s * g * n
                 + b * h * p * n),
            ssd.flops(b, s, h, p, n, SEQ)))),
        # the same with dt per head and h0 read: the bhcp call's work
        "bhcp_bound_ms": bound_ms(
            4 * (2 * b * h * s * p + b * h * s + h + 2 * b * g * s * n
                 + 2 * b * h * p * n),
            ssd.flops(b, s, h, p, n, SEQ))[0],
    }
    # rglru: the main path's call, the token entry on the predicate's ids
    # and tables with no h0; rglru_bsw on the gathered rows with a zero h0
    # under the bsw_ keys
    rx, rr, ri, a_param, rh0 = inputs.rglru_args(b)
    tables = inputs.rglru[:3]
    v, w = tables[0].shape
    o_out = torch.empty_like(rx)
    hl_out = torch.empty_like(rh0)
    out["rglru"] = {
        **paired_ms({
            "ms": lambda: rglru.rglru_tokens(ids, *tables, a_param),
            "entry_ms": entry("rglru", "rglru_tokens", rglru.TOKENS_ARGS.pack(
                ids.data_ptr(), *(t.data_ptr() for t in tables),
                a_param.data_ptr(), 0, o_out.data_ptr(), hl_out.data_ptr(),
                b, SEQ, w, v, 8.0, 0)),
            "bsw_ms": lambda: rglru.rglru_bsw(rx, rr, ri, a_param, rh0),
            "bsw_entry_ms": entry("rglru", "rglru_bsw", rglru.pack_args(
                rx, rr, ri, a_param, rh0, o_out, hl_out), "rglru_bsw")}),
        "plain_ms": time_ms(lambda: ref.rglru_tokens(ids, *tables, a_param),
                            iters),
        "bsw_plain_ms": time_ms(lambda: ref.rglru(rx, rr, ri, a_param, rh0),
                                iters),
        # ids, the three tables and a_param read once, out and h_last
        # written
        **dict(zip(("bound_ms", "bound_by"), bound_ms(
            4 * (b * SEQ + 3 * v * w + w + b * SEQ * w + b * w),
            b * rooflines.rglru(SEQ, w).flops_per_row))),
        # x, r and i, a_param and h0 read, out and h_last written
        "bsw_bound_ms": bound_ms(
            4 * (4 * b * SEQ * w + w + 2 * b * w),
            b * rooflines.rglru(SEQ, w).flops_per_row)[0],
    }
    out["ssd"]["bhcp_graph_ms"] = graphs["ssd_bhcp"]
    out["moe_router"]["tk_graph_ms"] = graphs["moe_router_tk"]
    out["rglru"]["bsw_graph_ms"] = graphs["rglru_bsw"]
    other = {"ssd": ("bhcp", "ssd_bhcp on contiguous copies"),
             "moe_router": ("tk", "moe_router_tk on the logits"),
             "rglru": ("bsw", "rglru_bsw on the gathered rows")}
    for name, t in out.items():
        t["library_ms"] = None  # no single PyTorch call computes it
        t["graph_ms"] = graphs[name]
        key, what = other[name]
        ops_ms = f", ops.ssd {t['ops_ms']!r} ms" if name == "ssd" else ""
        plain = (f", plain {t[key + '_plain_ms']!r}"
                 if key + "_plain_ms" in t else "")
        extra = (f"{ops_ms}; {what} {t[key + '_ms']!r} ms (entry point "
                 f"{t[key + '_entry_ms']!r}, in a graph "
                 f"{t[key + '_graph_ms']!r}{plain}, bound "
                 f"{t[key + '_bound_ms']!r})")
        print(f"  {name} B={b}: kernel {t['ms']!r} ms (entry point "
              f"{t['entry_ms']!r} ms, in a graph {t['graph_ms']!r} ms"
              f"{extra}), plain "
              f"{t['plain_ms']!r} ms, bound {t['bound_ms']!r} ms "
              f"({t['bound_by']})", flush=True)
    return out


# --------------------------------------------------------------------------- #
# phase 3: the attention kernels against their plain versions                 #
# --------------------------------------------------------------------------- #
def bhsd(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B * H, S, D), contiguous: the kernels' layout."""
    b, s, h, d = t.shape
    return t.transpose(1, 2).reshape(b * h, s, d).contiguous()


def score_of(out_bhsd: torch.Tensor, heads: int) -> torch.Tensor:
    """(B * H, S, D) kernel output -> (B,) predicate scores, the mean over
    (S, H, D) as the attention predicates take it."""
    from repro_torch.udfs.library import row_mean
    bh, s, d = out_bhsd.shape
    return row_mean(out_bhsd.reshape(bh // heads, heads, s, d).transpose(1, 2))


def check_close(name: str, got, want, label: str, tol=TOL_TIGHT,
                zero_rows=None, score=None) -> float:
    """Hold one kernel result against its plain version: every element
    within tol (rtol and atol, or a tensor of per-element limits), no NaN,
    the given rows exactly 0, and the predicate scores (``score``: (got,
    want)) within ATT_SCORE_ATOL."""
    extra = ""
    if isinstance(tol, torch.Tensor):
        err, share = limit_share(got, want, tol)
        ok = share <= 1.0
        extra = f", largest share of its limit {share!r}"
    else:
        err, ok = within(got, want, **tol)
    ok = ok and not bool(torch.isnan(got).any())
    if zero_rows is not None:
        zero = bool((got[zero_rows] == 0).all())
        ok, extra = ok and zero, f", masked rows exactly 0: {zero}"
    if score is not None:
        err_s, ok_s = within(score[0], score[1], 0.0, ATT_SCORE_ATOL)
        ok, extra = ok and ok_s, f"{extra}, score max_abs_err {err_s!r}"
    print(f"  {name} {label}: {tuple(got.shape)} {got.dtype} max_abs_err "
          f"{err!r}{extra}", flush=True)
    if not ok:
        raise AssertionError(f"{name} kernel disagrees on {label}")
    return err


def limit_share(got, want, limit: torch.Tensor) -> tuple:
    """(max abs error, the largest share of its per-element limit)."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), float((diff / limit).max())


class AttentionInputs:
    """The attention predicates' own kernel inputs for the first rows of
    the kept review table, made on the card by the library's featurizer,
    in the kernels' layout."""

    def __init__(self, toks_kept: np.ndarray):
        from repro_torch.udfs import library as lib
        dev = torch.device("cuda")
        self.toks = lib.token_ids(toks_kept[:BIG], ATT_SEQ, VOCAB, dev)
        self.flash = lib.attention_tables(device=dev)
        self.decode = lib.decode_tables(device=dev)

    def flash_args(self, b: int):
        """(q, k, v), each (2B, S, 8); group 1."""
        from repro_torch.udfs.library import attention_inputs
        return tuple(bhsd(t) for t in attention_inputs(self.flash,
                                                       self.toks[:b]))

    def decode_args(self, b: int):
        """(q (B, 2, 8), k_cache, v_cache (B, S, 8), lengths (B,) int32);
        one kv head."""
        from repro_torch.udfs.library import decode_inputs
        q, kc, vc, lens = decode_inputs(self.decode, self.toks[:b])
        return q.contiguous(), bhsd(kc), bhsd(vc), lens


def check_attention_kernels(inputs: AttentionInputs) -> dict:
    """Phase 3 for flash_attention and decode_attention: the JAX package's
    test shapes through ``ops`` (f32 and bf16, padded S, windows), the
    predicates' inputs at every bucketed batch and at BIG rows, fully
    masked rows, and the ops' block checks. Returns each kernel's largest
    float32 error and the largest bfloat16 error."""
    from repro_torch.kernels import decode_attention, flash_attention, ops, ref
    rng = np.random.default_rng(13)

    def T(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda().to(dtype)

    err = {"flash_attention": 0.0, "decode_attention": 0.0, "bf16": 0.0}
    # ---- flash: the JAX suite's shapes through ops (S = 200 is padded)
    for b, s, h, hkv, d in ((1, 128, 4, 4, 32), (2, 256, 4, 2, 64),
                            (1, 256, 8, 1, 64), (2, 200, 4, 2, 32)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (T(rng.standard_normal((b, s, n, d)), dtype)
                       for n in (h, hkv, hkv))
            e = check_close("flash_attention", ops.flash_attention(q, k, v),
                            ref.mha_attention(q, k, v),
                            f"ops B={b} S={s} H={h} Hkv={hkv} D={d}",
                            TOL_TIGHT if dtype == torch.float32 else TOL_BF16)
            key = "flash_attention" if dtype == torch.float32 else "bf16"
            err[key] = max(err[key], e)
    for window in (32, 100, 256):
        q, k, v = (T(rng.standard_normal((2, 256, n, 32))) for n in (4, 2, 2))
        err["flash_attention"] = max(err["flash_attention"], check_close(
            "flash_attention", ops.flash_attention(q, k, v, window=window),
            ref.mha_attention(q, k, v, window=window), f"ops window={window}"))
    # ---- flash: a window that hides every key from the queries past the
    # keys' end (Sq > Sk): rows >= 39 of 64, and whole tiles of 128 rows
    for sq in (64, 128):
        q = T(rng.standard_normal((4, sq, 16)))
        k, v = (T(rng.standard_normal((2, 32, 16))) for _ in range(2))
        got = flash_attention.flash_attention_bhsd(q, k, v, group=2, window=8)
        want = ref.flash_attention_bhsd(q, k, v, group=2, window=8)
        err["flash_attention"] = max(err["flash_attention"], check_close(
            "flash_attention", got, want, f"Sq={sq} Sk=32 window=8",
            zero_rows=(slice(None), slice(39, None))))
    # ---- flash: the predicate's inputs
    for b in (*BUCKETS, BIG):
        q, k, v = inputs.flash_args(b)
        got = flash_attention.flash_attention_bhsd(q, k, v, group=1)
        want = ref.flash_attention_bhsd(q, k, v, group=1)
        err["flash_attention"] = max(err["flash_attention"], check_close(
            "flash_attention", got, want, f"library B={b}",
            score=(score_of(got, 2), score_of(want, 2))))
    # ---- decode: the JAX suite's shapes through ops, lengths in [1, S]
    for b, s, h, hkv, d in ((2, 512, 4, 2, 64), (1, 256, 8, 8, 32),
                            (3, 512, 8, 1, 64)):
        q = T(rng.standard_normal((b, h, d)))
        kc, vc = (T(rng.standard_normal((b, s, hkv, d))) for _ in range(2))
        lens = torch.from_numpy(rng.integers(1, s + 1, (b,)).astype(np.int32)).cuda()
        err["decode_attention"] = max(err["decode_attention"], check_close(
            "decode_attention", ops.decode_attention(q, kc, vc, lens),
            ref.decode_attention(q, kc, vc, lens),
            f"ops B={b} S={s} H={h} Hkv={hkv} D={d}"))
    # ---- decode: lengths 0 (written as 0), past S (clamped), 1 and 17
    q = T(rng.standard_normal((8, 4, 64)))
    kc, vc = (T(rng.standard_normal((8, 96, 64))) for _ in range(2))
    lens = torch.tensor([0, 101, 1, 17], dtype=torch.int32, device="cuda")
    got = decode_attention.decode_attention_bkgd(q, kc, vc, lens, num_kv_heads=2)
    want = ref.decode_attention_bkgd(q, kc, vc, lens, num_kv_heads=2)
    err["decode_attention"] = max(err["decode_attention"], check_close(
        "decode_attention", got, want, "lengths 0, 101 > S=96, 1, 17",
        zero_rows=slice(0, 2)))
    # ---- decode: S = 40 (one block of 40) through ops; S = 48 with
    # blocks of 32 raises, as the JAX package's assert does
    q = T(rng.standard_normal((2, 4, 16)))
    kc, vc = (T(rng.standard_normal((2, 40, 2, 16))) for _ in range(2))
    lens = torch.tensor([40, 3], dtype=torch.int32, device="cuda")
    err["decode_attention"] = max(err["decode_attention"], check_close(
        "decode_attention", ops.decode_attention(q, kc, vc, lens),
        ref.decode_attention(q, kc, vc, lens), "ops S=40 block_k=256"))
    cache48 = torch.zeros((2, 48, 2, 16), device="cuda")
    try:
        ops.decode_attention(q, cache48, cache48, lens, block_k=32)
    except ValueError as e:
        print(f"  decode_attention ops S=48 block_k=32 raises: {e}")
    else:
        raise AssertionError("decode with S not a multiple of the block ran")
    # ---- decode: the predicate's inputs
    for b in (*BUCKETS, BIG):
        q, kc, vc, lens = inputs.decode_args(b)
        got = decode_attention.decode_attention_bkgd(q, kc, vc, lens,
                                                     num_kv_heads=1)
        want = ref.decode_attention_bkgd(q, kc, vc, lens, num_kv_heads=1)
        err["decode_attention"] = max(err["decode_attention"], check_close(
            "decode_attention", got, want, f"library B={b}",
            score=(score_of(got, 1), score_of(want, 1))))
    # ---- decode: every edge of the fixed 256-key split at S = 4,096
    b, s, hkv, g, d = 8, 4096, 2, 4, 64
    lens = torch.tensor([0, 1, 255, 256, 257, 4095, 4096, 5000],
                        dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q = T(rng.standard_normal((b * hkv, g, d)), dtype)
        kc, vc = (T(rng.standard_normal((b * hkv, s, d)), dtype)
                  for _ in range(2))
        got = decode_attention.decode_attention_bkgd(q, kc, vc, lens,
                                                     num_kv_heads=hkv)
        e = check_close("decode_attention", got, ref.decode_attention_bkgd(
            q, kc, vc, lens, num_kv_heads=hkv),
            f"S={s} split edges {lens.tolist()} {dtype}",
            TOL_TIGHT if dtype == torch.float32 else TOL_BF16,
            zero_rows=slice(0, hkv))
        key = "decode_attention" if dtype == torch.float32 else "bf16"
        err[key] = max(err[key], e)
        if dtype == torch.float32:   # the split kernel's own arithmetic
            err[key] = max(err[key], check_close(
                "decode_attention", got, ref.decode_attention_split(
                    q, kc, vc, lens, num_kv_heads=hkv,
                    split=decode_attention.SPLIT),
                "split edges against ref.decode_attention_split"))
    # ---- both: strided (B, S, H, D) views straight into the kernels
    # through ops, the output their only allocation
    def allocations() -> int:
        return torch.cuda.memory_stats()["allocation.all.allocated"]

    for d in (64, 6):   # 6: rows that are not 16-byte aligned
        b, s, h, hkv = 2, 200, 4, 2
        qbase = T(rng.standard_normal((b, s, h + 2, d)))
        kv = T(rng.standard_normal((b, s, 2, hkv, d)))
        q, k, v = qbase[:, :, 1:h + 1], kv[:, :, 0], kv[:, :, 1]
        before = allocations()
        got = ops.flash_attention(q, k, v)
        extra = allocations() - before - 1
        err["flash_attention"] = max(err["flash_attention"], check_close(
            "flash_attention", got, ref.mha_attention(
                q.contiguous(), k.contiguous(), v.contiguous()),
            f"ops on strided views D={d}, allocations besides the output: "
            f"{extra}"))
        dq = qbase[:, 7, 1:h + 1]
        lens = torch.tensor([150, 3], dtype=torch.int32, device="cuda")
        before = allocations()
        got = ops.decode_attention(dq, k, v, lens, block_k=s)
        extra_d = allocations() - before - 1
        err["decode_attention"] = max(err["decode_attention"], check_close(
            "decode_attention", got, ref.decode_attention(
                dq.contiguous(), k.contiguous(), v.contiguous(), lens),
            f"ops on strided views D={d}, allocations besides the output: "
            f"{extra_d}"))
        if extra or extra_d:
            raise AssertionError("ops copied an operand")
    print(f"  largest errors: float32 flash {err['flash_attention']!r}, "
          f"decode {err['decode_attention']!r}; bfloat16 flash "
          f"{err['bf16']!r} (tolerance {TOL_BF16})", flush=True)
    return err


def visible_pairs(s: int, causal: bool, window: int,
                  sk: int | None = None) -> int:
    """(query, key) pairs a causal or sliding-window mask leaves between S
    queries and ``sk`` keys (default S), both from position 0."""
    from repro_torch.kernels import flash_attention
    return flash_attention.visible_pairs(s, s if sk is None else sk, causal,
                                         window)


def time_flash(q, k, v, *, group: int, causal: bool, window: int,
               label: str, before=None) -> dict:
    """Times of the flash kernel on (BH, S, D) inputs in its layout, or on
    the model's (B, S, H, D) views (4-d inputs, through
    ``flash_attention_bshd``; there k and v may hold another length than
    q, as the cross-attention's do): through the wrapper, at its C entry
    point, at ``before``'s (an earlier source's entry point, from
    ``build_before``; given) and of ``scaled_dot_product_attention`` on the
    same work (in q's dtype), taken in turns (``paired_ms``), and of the
    plain version, beside the bound (each input read once and the output
    written once; 4 flops per visible (query, key) pair and dim). In bf16
    the call must take a wgmma design fed by TMA (``flash_attention_route``)
    and give the same bits on a rerun, and both bf16 designs
    (``flash_attention_variant``: a CTA a query tile, and the shared
    design) are timed in the same turns (``variant<n>_ms``): the call must
    give the bits of the design its route names, and the design of a CTA a
    query tile those of ``before``'s source (given: the same kernel); in
    float32 the call's bits must equal ``before``'s."""
    from repro_torch.kernels import _build, flash_attention, ref
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.load("flash_attention").lib
    call = lib.flash_attention_bshd
    sk = k.shape[1]
    if q.dim() == 4:
        b, s, h, d = q.shape
        bh = b * h

        def pack(o):
            return flash_attention.pack_args(
                q, k, v, o,
                tuple(map(flash_attention.bshd_layout, (q, k, v, o))),
                batch=b, heads=h, group=group, sq=s, sk=sk, causal=causal,
                window=window, scale=d ** -0.5)
        wrapper = lambda: flash_attention.flash_attention_bshd(  # noqa: E731
            q, k, v, causal=causal, window=window)
        plain = lambda: ref.flash_attention_bshd(  # noqa: E731
            q, k, v, causal=causal, window=window)
        q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
    else:
        bh, s, d = q.shape
        lay = flash_attention.bhsd_layout

        def pack(o):
            return flash_attention.pack_args(
                q, k, v, o,
                (lay(q, group), lay(k, 1), lay(v, 1), lay(o, group)),
                batch=bh // group, heads=group, group=group, sq=s, sk=s,
                causal=causal, window=window, scale=d ** -0.5)
        wrapper = lambda: flash_attention.flash_attention_bhsd(  # noqa: E731
            q, k, v, group=group, causal=causal, window=window)
        plain = lambda: ref.flash_attention_bhsd(  # noqa: E731
            q, k, v, group=group, causal=causal, window=window)
        # the same work for scaled_dot_product_attention: the programs as
        # the heads of one sequence (query head i reads kv head i // group)
        q4, k4, v4 = q.unsqueeze(0), k.unsqueeze(0), v.unsqueeze(0)
    args = pack(out)
    if call(args, stream) != 0:
        raise AssertionError("flash_attention entry point failed")
    fns, checks = {"ms": wrapper, "entry_ms": lambda: call(args, stream)}, {}
    if q.dtype == torch.bfloat16:
        rerun = torch.empty_like(q)
        if call(pack(rerun), stream) != 0:
            raise AssertionError("flash_attention entry point failed")
        torch.cuda.synchronize()
        checks["route"] = flash_attention.ROUTES[lib.flash_attention_route(
            args)]
        checks["rerun_bit_equal"] = torch.equal(out, rerun)
        designs = {}
        for n in flash_attention.VARIANTS:
            got = designs[n] = torch.empty_like(q)
            n_args = pack(got)
            if lib.flash_attention_variant(n_args, n, stream) != 0:
                raise AssertionError(f"flash_attention {label}: design {n} "
                                     "failed")
            fns[f"variant{n}_ms"] = (
                lambda a=n_args, n=n: lib.flash_attention_variant(
                    a, n, stream))
        torch.cuda.synchronize()
        routed = 2 if "shared" in checks["route"] else 1
        checks["call_is_its_routes_design"] = torch.equal(out,
                                                          designs[routed])
        if checks["route"] not in flash_attention.TMA_ROUTES or \
                not all(v for key, v in checks.items() if key != "route"):
            raise AssertionError(f"flash_attention {label}: {checks}")
    if before is not None:
        old = torch.empty_like(q)
        old_args = pack(old)
        if before(old_args, stream) != 0:
            raise AssertionError("the earlier flash entry point failed")
        torch.cuda.synchronize()
        fns["before_ms"] = lambda: before(old_args, stream)
        if q.dtype == torch.bfloat16:
            checks["per_tile_bit_equal_to_before"] = torch.equal(
                designs[1], old)
            if not checks["per_tile_bit_equal_to_before"]:
                raise AssertionError(f"flash_attention {label}: a CTA a "
                                     "query tile differs from the earlier "
                                     "source's kernel")
        if q.dtype == torch.float32:
            checks["bit_equal_to_before"] = torch.equal(out, old)
            if not checks["bit_equal_to_before"]:
                raise AssertionError(f"flash_attention {label}: float32 "
                                     "differs from the earlier source's")
    if window > 0:
        i = torch.arange(s, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        fns["library_ms"] = lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True)
    else:
        fns["library_ms"] = lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, enable_gqa=True)
    big = bh * s > 2 * 4096 or s * sk > 2 ** 22
    t = {
        "dtype": str(q.dtype).replace("torch.", ""),
        **paired_ms(fns),
        "plain_ms": time_ms(plain, 10 if big else TIME_ITERS),
        **tensor_core_bound(
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
            4.0 * visible_pairs(s, causal, window, sk) * bh * d, q.dtype),
        **checks,
    }
    extra = (f", the earlier source's entry point {t['before_ms']!r} ms "
             f"({t['before_ms'] / t['entry_ms']!r} x this one's)"
             if "before_ms" in t else "")
    extra += "".join(f", design {n} {t[f'variant{n}_ms']!r} ms"
                     for n in flash_attention.VARIANTS
                     if f"variant{n}_ms" in t)
    print(f"  flash_attention {label}: kernel {t['ms']!r} ms (entry point "
          f"{t['entry_ms']!r} ms{extra}), plain {t['plain_ms']!r} ms, "
          f"scaled_dot_product_attention {t['library_ms']!r} ms, bound "
          f"{t['bound_ms']!r} ms ({t['bound_by']}; float32 CUDA cores "
          f"{t['bound_f32_cores_ms']!r} ms)"
          f"{'; ' + str(checks) if checks else ''}", flush=True)
    return t


def time_decode(q, kc, vc, lens, *, num_kv_heads: int, label: str) -> dict:
    """Times of the decode kernel on (B * Hkv, G, D) queries against (B *
    Hkv, S, D) caches, as ``time_flash`` times the flash kernel; the bound
    counts the cache entries the lengths leave (4 flops a key, row and
    dim) and SDPA gets the same work as a length mask."""
    from repro_torch.kernels import _build, decode_attention, ref
    from repro_torch.kernels.flash_attention import bhsd_layout
    bkv, g, d = q.shape
    s = kc.shape[1]
    b = bkv // num_kv_heads
    out = torch.empty_like(q)
    n = decode_attention.splits(s)
    part = torch.empty(bkv * n * g * (d + 2), device=q.device) if n > 1 \
        else None
    stream = torch.cuda.current_stream().cuda_stream
    call = _build.load("decode_attention").lib.decode_attention_bshd
    args = decode_attention.pack_args(
        q, kc, vc, lens, out, part,
        tuple(bhsd_layout(t, num_kv_heads) for t in (q, kc, vc, out)),
        batch=b, kv_heads=num_kv_heads, g=g, s=s, scale=d ** -0.5)
    if call(args, stream) != 0:
        raise AssertionError("decode_attention entry point failed")
    used = lens.to(torch.int64).clamp(0, s).repeat_interleave(num_kv_heads)
    keys = int(used.sum())
    q4 = q.reshape(b, num_kv_heads * g, 1, d)
    k4 = kc.reshape(b, num_kv_heads, s, d)
    v4 = vc.reshape(b, num_kv_heads, s, d)
    mask = (torch.arange(s, device=q.device)[None, :]
            < lens.to(torch.int64)[:, None])[:, None, None, :]
    t = {
        "dtype": str(q.dtype).replace("torch.", ""),
        **paired_ms({
            "ms": lambda: decode_attention.decode_attention_bkgd(
                q, kc, vc, lens, num_kv_heads=num_kv_heads),
            "entry_ms": lambda: call(args, stream),
            "library_ms": lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=True)}),
        "plain_ms": time_ms(lambda: ref.decode_attention_bkgd(
            q, kc, vc, lens, num_kv_heads=num_kv_heads), TIME_ITERS),
        **tensor_core_bound((2 * q.numel() + 2 * keys * d) * q.element_size()
                            + lens.numel() * 4, 4.0 * keys * g * d, q.dtype),
    }
    print(f"  decode_attention {label}: kernel {t['ms']!r} ms (entry point "
          f"{t['entry_ms']!r} ms), plain {t['plain_ms']!r} ms, "
          f"scaled_dot_product_attention {t['library_ms']!r} ms, bound "
          f"{t['bound_ms']!r} ms ({t['bound_by']})", flush=True)
    return t


def time_attention(inputs: AttentionInputs, b: int, before=None) -> dict:
    """Both attention kernels on the predicates' inputs for b rows (flash
    beside ``before``'s entry point, given, and bit-equal to it)."""
    q, k, v = inputs.flash_args(b)
    flash = time_flash(q, k, v, group=1, causal=True, window=0,
                       label=f"B={b}", before=before)
    dq, kc, vc, lens = inputs.decode_args(b)
    decode = time_decode(dq, kc, vc, lens, num_kv_heads=1, label=f"B={b}")
    return {"flash_attention": flash, "decode_attention": decode}


def time_attention_bench(before=None) -> dict:
    """Both attention kernels at the JAX package's bench_kernels shapes
    (flash beside ``before``'s entry point, given):
    flash in float32 (and the causal shapes in bfloat16, beside SDPA in
    bfloat16), decode with full lengths and with lengths drawn from the
    seed in [1, S]."""
    rng = np.random.default_rng(14)
    out = {}
    for b, s, h, hkv, d, window in FLASH_BENCH:
        qkv = [torch.from_numpy(rng.standard_normal((b, s, n, d)).astype(
            np.float32)).cuda() for n in (h, hkv, hkv)]
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16 and window:
                continue
            q, k, v = (bhsd(t.to(dtype)) for t in qkv)
            label = (f"bench B={b} S={s} H={h} Hkv={hkv} D={d} "
                     f"window={window}")
            if dtype == torch.bfloat16:
                label += " bf16"
            out[label] = {"flash_attention": time_flash(
                q, k, v, group=h // hkv, causal=True, window=window,
                label=label, before=before)}
    b, s, h, hkv, d = DECODE_BENCH
    q = torch.from_numpy(rng.standard_normal((b * hkv, h // hkv, d)).astype(
        np.float32)).cuda()
    kc, vc = (bhsd(torch.from_numpy(rng.standard_normal(
        (b, s, hkv, d)).astype(np.float32)).cuda()) for _ in range(2))
    for name, lens in (
            ("", torch.full((b,), s, dtype=torch.int32, device="cuda")),
            (" lengths 1-S", torch.from_numpy(rng.integers(
                1, s + 1, (b,)).astype(np.int32)).cuda())):
        label = f"bench B={b} S={s} H={h} Hkv={hkv} D={d}{name}"
        print(f"  {label}: lengths {lens.tolist()}")
        out[label] = {"decode_attention": time_decode(
            q, kc, vc, lens, num_kv_heads=hkv, label=label)}
    return out


# --------------------------------------------------------------------------- #
# phases 6 and 7: the review-triage query and the text registry               #
# --------------------------------------------------------------------------- #
def triage_oracles(table, toks_kept: np.ndarray, ids_kept: np.ndarray) -> dict:
    """The triage conjunction over the whole kept table, once through the
    predicates (the kernels, one launch each), once through the kernel
    wrappers directly (the router's token entry on the int32 ids, whose
    logits must equal the featurizer's bit for bit) and once through the
    plain versions on the card, on the same inputs. All three must
    agree."""
    from repro_torch.examples.review_triage import oracle_ids, triage_predicates
    from repro_torch.kernels import moe_router, ref, ssd
    from repro_torch.udfs import library as lib
    dev = torch.device("cuda")
    preds = triage_predicates(expert=0, device=dev)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for the text predicates")
    t0 = time.perf_counter()
    through_predicates = oracle_ids(table, preds, max_rating=2)
    t_pred = time.perf_counter() - t0

    toks = lib.token_ids(toks_kept, SEQ, VOCAB, dev)
    emb, w_gate = lib.router_tables(device=dev)
    logits = ref.router_logits(emb, w_gate, toks)
    logits_k = torch.empty_like(logits)
    w_k, idx_k = moe_router.moe_router_tokens(toks, emb, w_gate, 2, logits_k)
    w_p, idx_p = ref.moe_topk_router(logits, 2)
    x, dt, A, Bm, Cm = lib.ssd_inputs(lib.ssd_tables(device=dev), toks)
    score_k = lib.row_mean(ssd.ssd_bshp(x, dt, A, Bm, Cm, chunk=SEQ)[0])
    score_p = lib.row_mean(ref.ssd(x, dt, A, Bm, Cm, chunk=SEQ)[0])
    probs = ref.softmax(logits).sort(dim=-1, descending=True).values
    torch.cuda.synchronize()
    mask_k = ((idx_k[:, 0] == 0) & (score_k > 0)).cpu().numpy()
    mask_p = ((idx_p[:, 0] == 0) & (score_p > 0)).cpu().numpy()
    through_kernels = set(ids_kept[mask_k].tolist())
    through_plain = set(ids_kept[mask_p].tolist())
    stats = {
        "rows": len(toks_kept), "expected_rows": len(through_predicates),
        "oracle_s_through_predicates": t_pred,
        "min_abs_score": float(score_p.abs().min()),
        "min_top1_top2_gap": float((probs[:, 0] - probs[:, 1]).min()),
        "score_max_abs_err": float((score_k - score_p).abs().max()),
        "router_logits_bit_equal": torch.equal(logits_k, logits),
        "router_weight_max_abs_err": float((w_k - w_p).abs().max()),
        "router_idx_rows_differing": int((idx_k != idx_p).any(-1).sum()),
        "ssd_decisions_differing": int(((score_k > 0) != (score_p > 0)).sum()),
    }
    print(f"  oracle over {len(toks_kept)} kept rows: {len(through_predicates)} "
          f"rows through the predicates ({t_pred:.2f}s), "
          f"{len(through_kernels)} through the kernel wrappers, "
          f"{len(through_plain)} through the plain versions")
    print(f"  smallest |score| {stats['min_abs_score']!r}, smallest top-1/top-2 "
          f"gap {stats['min_top1_top2_gap']!r}; kernel vs plain: score "
          f"{stats['score_max_abs_err']!r}, router logits bit-equal "
          f"{stats['router_logits_bit_equal']}, router weights "
          f"{stats['router_weight_max_abs_err']!r}, idx rows differing "
          f"{stats['router_idx_rows_differing']}, ssd decisions differing "
          f"{stats['ssd_decisions_differing']}", flush=True)
    if not stats["router_logits_bit_equal"]:
        raise AssertionError("moe_router_tokens' logits differ from "
                             "router_logits over the kept table")
    if not (through_predicates == through_kernels == through_plain):
        raise AssertionError("the triage oracles disagree: kernels vs plain "
                             f"{sorted(through_kernels ^ through_plain)[:10]}")
    if not through_predicates:
        raise AssertionError("the triage query should match some reviews")
    return {"expect": through_predicates, "stats": stats}


def batch_invariance(toks_kept: np.ndarray) -> dict:
    """A row's router logits, top-1 expert, SSD score and RG-LRU state,
    computed alone and in batches of 3, 16 and BIG rows, against the same
    rows in the whole table: the port's path must give the same bits.
    Also counts how many rows a plain ``torch.matmul`` gate and ``sum``
    would have changed, to show which library call the fixed-order
    featurizer avoids."""
    from repro_torch.kernels import moe_router, rglru, ssd
    from repro_torch.udfs import library as lib
    dev = torch.device("cuda")
    router, ssd_t = lib.router_tables(device=dev), lib.ssd_tables(device=dev)
    rglru_t = lib.rglru_tables(device=dev)
    toks = lib.token_ids(toks_kept, SEQ, VOCAB, dev)

    def path(t):
        logits = torch.empty((t.shape[0], router[1].shape[1]), device=dev)
        _, idx = moe_router.moe_router_tokens(t, *router, 2, logits)
        y, _ = ssd.ssd_bshp(*lib.ssd_inputs(ssd_t, t), chunk=SEQ)
        _, h_last = rglru.rglru_tokens(t, *rglru_t)
        return logits, idx[:, 0], lib.row_mean(y), h_last

    def library_gate(t):
        emb, w_gate = router
        live = (t > 0).sum(1, keepdim=True).clamp_min(1).float()
        return (emb[t].sum(1) / live) @ w_gate

    whole = path(toks)
    whole_lib = library_gate(toks)
    out = {}
    for b in (1, 3, 16, BIG):
        part = path(toks[:b])
        same = all(torch.equal(p, w[:b]) for p, w in zip(part, whole))
        changed = int((library_gate(toks[:b]) != whole_lib[:b]).any(-1).sum())
        out[str(b)] = {"port_bit_equal": same, "library_gate_rows_changed": changed}
        print(f"  batch of {b}: port path bit-equal to the whole table {same}; "
              f"sum + matmul gate would change {changed} of {b} rows",
              flush=True)
        if not same:
            raise AssertionError(f"the text path is not batch-invariant at B={b}")
    return out


class OpCount(TorchDispatchMode):
    """Counts the torch operations dispatched inside a ``with`` block
    (each aten call, on any device)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def predicate_calls(toks_kept: np.ndarray, rows: int = 16,
                    calls: int = 200) -> dict:
    """One call of the router and RG-LRU predicates on ``rows`` kept rows:
    through the token entries (one launch, no featurizer), against the
    same call as the parent made it (the torch featurizer or gather, then
    ``moe_router_tk`` or ``rglru_bsw`` on a zero h0). Outputs must agree;
    counts the torch operations of each call and times ``calls`` calls of
    each on the host clock (a call ends in the copy back, so its device
    work is inside), the two taken in turns (``paired_ms``'s order)."""
    from repro_torch.kernels import launch, ops, ref
    from repro_torch.udfs import build_predicate
    from repro_torch.udfs import library as lib
    dev = torch.device("cuda")
    data = {"tokens": toks_kept[:rows]}
    emb, w_gate = lib.router_tables(device=dev)
    emb_x, emb_r, emb_i, a_param = lib.rglru_tables(device=dev)

    def router_parent(d):
        with launch.thread_stream(dev):
            toks = lib.token_ids(d["tokens"], SEQ, VOCAB, dev).long()
            _, idx = ops.moe_topk_router(ref.router_logits(emb, w_gate, toks),
                                         2)
            return idx[:, 0].cpu().numpy()

    def rglru_parent(d):
        with launch.thread_stream(dev):
            toks = lib.token_ids(d["tokens"], SEQ, VOCAB, dev).long()
            h0 = torch.zeros((toks.shape[0], a_param.shape[0]), device=dev)
            _, h_last = ops.rglru(emb_x[toks], emb_r[toks], emb_i[toks],
                                  a_param, h0)
            return lib.row_mean(h_last).cpu().numpy()

    pairs = {"moe_router": (build_predicate("moe_router", device=dev,
                                            seq=SEQ).udf.fn, router_parent),
             "rglru": (build_predicate("rglru", device=dev, seq=SEQ).udf.fn,
                       rglru_parent)}
    out = {}
    for name, (new, parent) in pairs.items():
        if not np.array_equal(new(data), parent(data)):
            raise AssertionError(f"the {name} predicate's token path and the "
                                 "parent's path disagree")
        counts = {}
        for key, fn in (("token_entry", new), ("parent_path", parent)):
            with OpCount() as c:
                fn(data)
            counts[key] = len(c.ops)
        times = {"token_entry": [], "parent_path": []}
        for r in range(5):
            order = ("token_entry", "parent_path")
            for key in (order if r % 2 == 0 else order[::-1]):
                fn = new if key == "token_entry" else parent
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn(data)
                times[key].append((time.perf_counter() - t0) / calls * 1e3)
        out[name] = {"rows": rows, "torch_ops": counts,
                     "call_ms": {k: float(np.median(v))
                                 for k, v in times.items()}}
        print(f"  {name} predicate, {rows} rows: torch operations a call "
              f"{counts['token_entry']} through the token entry, "
              f"{counts['parent_path']} as the parent called it; host ms a "
              f"call {out[name]['call_ms']['token_entry']!r} against "
              f"{out[name]['call_ms']['parent_path']!r}", flush=True)
    if out["moe_router"]["torch_ops"]["token_entry"] > 8:
        raise AssertionError("the router predicate issues more than 8 torch "
                             "operations a call")
    return out


def run_triage(table, expect: set) -> dict:
    """The triage query on the card under every eddy policy; the kernel
    counters are set to 0 just before the policies run and read just
    after."""
    from repro_torch.core.policies import EDDY_POLICIES
    from repro_torch.examples.review_triage import build_plan
    from repro_torch.kernels import launch, moe_router, ssd
    per_policy = {}
    board = collections.Counter()
    sizes = {"moe_router": collections.Counter(), "ssd": collections.Counter()}
    moe_router.launches = ssd.launches = 0
    for policy in sorted(EDDY_POLICIES):
        _, plan = build_plan(table, policy=policy, device="cuda", expert=0,
                             max_rating=2, max_workers=4)
        events = []
        hook = launch.add_launch_hook(events.append)
        t0 = time.perf_counter()
        try:
            rows = plan.collect_rows()
        finally:
            wall = time.perf_counter() - t0
            launch.remove_launch_hook(hook)
        got = set(rows["_row_id"].tolist())
        snap = plan.executor.stats_snapshot()
        if got != expect:
            raise AssertionError(
                f"triage {policy}: {len(got)} rows, expected {len(expect)}; "
                f"missing {sorted(expect - got)[:10]} extra "
                f"{sorted(got - expect)[:10]}")
        entry = {"wall_s": wall, "rows": len(got)}
        for name in ("moe_router", "ssd"):
            e = snap.get(name)
            if e is None or e["batches"] <= 0:
                raise AssertionError(f"triage {policy}: no {name} board entry")
            board[name] += int(e["batches"])
            entry[name] = {"board_launches": int(e["batches"]),
                           "cost_per_row_ms": e["cost_per_row"] * 1e3}
        for ev in events:
            if ev.name in sizes:
                sizes[ev.name][ev.rows // SEQ if ev.name == "ssd" else ev.rows] += 1
                entry[ev.name]["hooked_launch_s"] = (
                    entry[ev.name].get("hooked_launch_s", 0.0) + ev.seconds)
        for name in ("MoERouter", "SSDScorer"):
            entry[name] = {"cost_per_row_ms": snap[name]["cost_per_row"] * 1e3,
                           "selectivity": snap[name]["selectivity"]}
        per_policy[policy] = entry
        print(f"  {policy}: {len(got)} rows in {wall!r} s; " + "; ".join(
            f"{k} board launches {entry[k]['board_launches']} cost/row "
            f"{entry[k]['cost_per_row_ms']!r} ms, launch to stream sync "
            f"{entry[k].get('hooked_launch_s', 0.0)!r} s in all"
            for k in ("moe_router", "ssd")), flush=True)
    launches = {"moe_router": moe_router.launches, "ssd": ssd.launches}
    print(f"  kernel launches {launches}, board launches {dict(board)}, "
          f"launch batch sizes {({k: dict(sorted(v.items())) for k, v in sizes.items()})}")
    for name, n in launches.items():
        if not (n > 0 and n >= board[name]):
            raise AssertionError(f"the triage query did not go through {name}")
    return {"policies": per_policy, "launches": launches, "board": dict(board),
            "sizes": {k: dict(sorted(v.items())) for k, v in sizes.items()}}


def attention_oracle(kernel: str, toks_kept: np.ndarray,
                     ids_kept: np.ndarray, expect: set) -> dict:
    """The attention predicate's whole-table oracle through the kernel
    wrapper and through the plain version on the card, on the same
    featurized inputs: both must give ``expect`` (the predicate's own)."""
    from repro_torch.kernels import decode_attention, flash_attention, ref
    from repro_torch.udfs import library as lib
    dev = torch.device("cuda")
    toks = lib.token_ids(toks_kept, ATT_SEQ, VOCAB, dev)
    if kernel == "flash_attention":
        q, k, v = (bhsd(t) for t in lib.attention_inputs(
            lib.attention_tables(device=dev), toks))
        score_k = score_of(flash_attention.flash_attention_bhsd(
            q, k, v, group=1), 2)
        score_p = score_of(ref.flash_attention_bhsd(q, k, v, group=1), 2)
    else:
        q, kc, vc, lens = lib.decode_inputs(lib.decode_tables(device=dev), toks)
        kc, vc = bhsd(kc), bhsd(vc)
        score_k = score_of(decode_attention.decode_attention_bkgd(
            q.contiguous(), kc, vc, lens, num_kv_heads=1), 1)
        score_p = score_of(ref.decode_attention_bkgd(
            q.contiguous(), kc, vc, lens, num_kv_heads=1), 1)
    torch.cuda.synchronize()
    through_kernel = set(ids_kept[(score_k > 0).cpu().numpy()].tolist())
    through_plain = set(ids_kept[(score_p > 0).cpu().numpy()].tolist())
    stats = {"min_abs_score": float(score_p.abs().min()),
             "score_max_abs_err": float((score_k - score_p).abs().max()),
             "decisions_differing": int(((score_k > 0) != (score_p > 0)).sum())}
    print(f"  {kernel} oracle: {len(expect)} rows through the predicate, "
          f"{len(through_kernel)} through the kernel wrapper, "
          f"{len(through_plain)} through the plain version; smallest |score| "
          f"{stats['min_abs_score']!r}, kernel vs plain score "
          f"{stats['score_max_abs_err']!r}, decisions differing "
          f"{stats['decisions_differing']}", flush=True)
    if not (expect == through_kernel == through_plain):
        raise AssertionError(f"the {kernel} oracles disagree")
    return stats


def run_registry(toks_kept: np.ndarray, ids_kept: np.ndarray) -> dict:
    """Each kernel predicate of the text table from ``build_predicate`` in
    an executor over the kept rows, against its own whole-table oracle
    (for the attention predicates also computed through the kernel wrapper
    and the plain version on the card). The counters are set to 0 after
    the oracles and read after the five runs."""
    from repro_torch.core import Query, optimize
    from repro_torch.core.policies import CostDriven
    from repro_torch.examples.review_triage import source
    from repro_torch.kernels import (decode_attention, flash_attention, launch,
                                     moe_router, rglru, ssd)
    from repro_torch.udfs import build_predicate
    kept_table = {"tokens": toks_kept, "_row_id": ids_kept}
    seqs = {"moe_router": SEQ, "ssd": SEQ, "rglru": SEQ,
            "flash_attention": ATT_SEQ, "decode_attention": ATT_SEQ}
    rows_per_input = {"moe_router": 1, "ssd": SEQ, "rglru": SEQ,
                      "flash_attention": 2 * ATT_SEQ, "decode_attention": 2}
    preds = {k: build_predicate(k, device="cuda", seq=seq)
             for k, seq in seqs.items()}
    expect = {k: set(ids_kept[p.mask_from_outputs(
        p.udf({"tokens": toks_kept}))].tolist()) for k, p in preds.items()}
    oracles = {k: attention_oracle(k, toks_kept, ids_kept, expect[k])
               for k in ("flash_attention", "decode_attention")}
    modules = {"moe_router": moe_router, "ssd": ssd, "rglru": rglru,
               "flash_attention": flash_attention,
               "decode_attention": decode_attention}
    for m in modules.values():
        m.launches = 0
    out = {}
    for kernel, p in preds.items():
        plan = optimize(Query(source=source(kept_table), predicates=[p]),
                        executor_kwargs=dict(policy=CostDriven(), max_workers=4))
        events = []
        hook = launch.add_launch_hook(events.append)
        t0 = time.perf_counter()
        try:
            got = set(plan.collect_rows()["_row_id"].tolist())
        finally:
            wall = time.perf_counter() - t0
            launch.remove_launch_hook(hook)
        sizes = collections.Counter(ev.rows // rows_per_input[kernel]
                                    for ev in events if ev.name == kernel)
        entry = plan.executor.stats_snapshot().get(kernel)
        print(f"  {kernel} ({p.name}): {len(got)} of {len(ids_kept)} rows in "
              f"{wall!r} s; board launches "
              f"{int(entry['batches']) if entry else 0}", flush=True)
        if got != expect[kernel]:
            raise AssertionError(f"registry {kernel}: {len(got)} rows, oracle "
                                 f"{len(expect[kernel])}")
        if entry is None or entry["batches"] <= 0:
            raise AssertionError(f"registry {kernel}: no board entry")
        out[kernel] = {"rows": len(got), "wall_s": wall,
                       "board_launches": int(entry["batches"]),
                       "sizes": dict(sorted(sizes.items()))}
    launches = {k: m.launches for k, m in modules.items()}
    print(f"  kernel launches {launches}")
    for kernel, n in launches.items():
        if not (n > 0 and n >= out[kernel]["board_launches"]):
            raise AssertionError(f"the registry run did not go through {kernel}")
    return {"runs": out, "launches": launches, "oracles": oracles,
            "expect": expect}


# --------------------------------------------------------------------------- #
# phase 8: three tenants of the port's QueryService at once                   #
# --------------------------------------------------------------------------- #
def run_service(reviews, expect: dict) -> dict:
    """The triage, attention and decode queries submitted together to one
    ``QueryService(max_concurrent=3)``, each built as the serving layer's
    CLI builds its query (``Query`` over ``review_source`` with ``rating <=
    2``, ``batches_of``); each tenant's rows against its oracle. The
    kernel counters are set to 0 just before the submits and read after
    the last result; a launch hook counts the launches each tenant's
    board saw (those made under a tenant's launch context)."""
    from repro_torch import udfs
    from repro_torch.core import Query, TrivialPredicate, batches_of
    from repro_torch.core.policies import EDDY_POLICIES, DataAware
    from repro_torch.examples.review_triage import triage_predicates
    from repro_torch.kernels import (decode_attention, flash_attention, launch,
                                     moe_router, ssd)
    from repro_torch.launch.serve import QueryService, review_source
    tenants = {
        "triage": (triage_predicates(expert=0, device="cuda"), "hydro"),
        "attention": ([udfs.attention_scorer_predicate(device="cuda")], "cost"),
        "decode": ([udfs.decode_relevance_predicate(device="cuda")],
                   "selectivity"),
    }
    modules = {"moe_router": moe_router, "ssd": ssd,
               "flash_attention": flash_attention,
               "decode_attention": decode_attention}
    board = collections.Counter()
    sizes = {"flash_attention": collections.Counter(),
             "decode_attention": collections.Counter()}
    per_row = {"flash_attention": 2 * ATT_SEQ, "decode_attention": 2}

    def count(ev):
        if launch.current_launch_context() is not None:
            board[ev.name] += 1
            if ev.name in sizes:
                sizes[ev.name][ev.rows // per_row[ev.name]] += 1

    reports = {}
    hook = launch.add_launch_hook(count)
    t0 = time.perf_counter()
    try:
        with QueryService(max_concurrent=3) as svc:
            for m in modules.values():
                m.launches = 0
            handles = {}
            for name, (preds, policy) in tenants.items():
                q = Query(source=review_source(reviews), predicates=preds,
                          trivial=[TrivialPredicate("rating", "<=", 2)])
                handles[name] = svc.submit(
                    preds, batches_of(q), policy=EDDY_POLICIES[policy](),
                    laminar_policy_factory=DataAware, max_workers=4,
                    qid=name)
            for name, h in handles.items():
                reports[name] = h.result(timeout=900)
            launches = {k: m.launches for k, m in modules.items()}
            snapshot = svc.snapshot()
    finally:
        wall = time.perf_counter() - t0
        launch.remove_launch_hook(hook)
    out = {"wall_s": wall, "tenants": {}, "launches": launches,
           "board": dict(board), "snapshot": snapshot,
           "sizes": {k: dict(sorted(v.items())) for k, v in sizes.items()}}
    for name, rep in reports.items():
        got = set(map(int, rep.row_ids))
        print(f"  {name} ({tenants[name][1]}): {rep.state}, {len(got)} rows, "
              f"queue {rep.queue_time_s!r} s, eval {rep.eval_time_s!r} s, "
              f"{rep.batches} batches; board {list(rep.board_predicates)}",
              flush=True)
        if got != expect[name]:
            raise AssertionError(
                f"service tenant {name}: {len(got)} rows, oracle "
                f"{len(expect[name])}; missing {sorted(expect[name] - got)[:10]}"
                f" extra {sorted(got - expect[name])[:10]}")
        out["tenants"][name] = {
            "rows": len(got), "policy": tenants[name][1],
            "queue_time_s": rep.queue_time_s, "eval_time_s": rep.eval_time_s,
            "batches": rep.batches, "board_predicates": rep.board_predicates}
    print(f"  service wall {wall!r} s; snapshot {snapshot}")
    print(f"  kernel launches {launches}, board launches {dict(board)}, "
          f"attention launch sizes {out['sizes']}", flush=True)
    if snapshot["completed"] != 3:
        raise AssertionError(f"the service completed {snapshot['completed']} "
                             "of 3 queries")
    for kernel, n in launches.items():
        if not (n > 0 and n >= board[kernel]):
            raise AssertionError(f"the service did not go through {kernel}")
    return out


# --------------------------------------------------------------------------- #
# phase 9: the LLM(...) predicate at SmolLM-135M's full width                 #
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def plain_kernels():
    """Inside the block the models run the kernels' plain versions
    (``ref.flash_attention_bshd``, ``ref.ssd``, ``ref.rglru``,
    ``ref.moe_topk_router``): the wrappers are swapped out of
    ``models.attention``, ``models.ssm``, ``models.hybrid`` and
    ``models.moe``. Only for the main thread's comparisons, while no
    query runs."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention, hybrid, moe, ssm
    swaps = ((attention, "flash_attention_bshd", ref.flash_attention_bshd),
             (ssm, "ssd_bshp", ref.ssd), (hybrid, "rglru_bsw", ref.rglru),
             (moe, "moe_router_tk", ref.moe_topk_router))
    kernels = [(module, name, getattr(module, name))
               for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for module, name, kernel in kernels:
            setattr(module, name, kernel)


def llm_scores(fn, tokens: np.ndarray, rows: int) -> np.ndarray:
    """The LLM predicate's score of every row, ``rows`` rows a call."""
    return np.concatenate([fn({"tokens": tokens[i:i + rows]})
                           for i in range(0, len(tokens), rows)])


def check_llm_forward(cfg, model, x: torch.Tensor) -> dict:
    """One forward through the kernel: one launch a layer, and logits
    within TOL_BF16 of the same forward with the plain attention."""
    from repro_torch.kernels import flash_attention
    from repro_torch.models import transformer as tf
    with torch.inference_mode():
        before = flash_attention.launches
        logits = tf.forward(cfg, model, {"tokens": x})
        after = flash_attention.launches
        with plain_kernels():
            plain = tf.forward(cfg, model, {"tokens": x})
    err, ok = within(logits, plain, **TOL_BF16)
    finite = bool(torch.isfinite(logits).all())
    print(f"  forward {tuple(x.shape)}: logits {tuple(logits.shape)} "
          f"{logits.dtype}, max_abs_err against the plain attention {err!r} "
          f"(|logit| up to {float(plain.float().abs().max())!r}), finite "
          f"{finite}; flash_attention.launches {before} -> {after}",
          flush=True)
    if after - before != cfg.num_layers:
        raise AssertionError(f"the forward launched the flash kernel "
                             f"{after - before} times, not {cfg.num_layers}")
    if not (ok and finite):
        raise AssertionError("the forward through the flash kernel disagrees "
                             "with the plain attention")
    return {"shape": list(x.shape), "launches": after - before,
            "max_abs_err": err}


def check_llm_decode(cfg, model, prompt: torch.Tensor) -> dict:
    """A prefill of the prompt, then LLM_STEPS greedy decode steps: the
    prefill's and each step's logits within TOL_BF16 of a full forward's
    last position over the same tokens."""
    from repro_torch.models import transformer as tf
    errs = []
    with torch.inference_mode():
        cache, last = tf.prefill(cfg, model, {"tokens": prompt},
                                 pad_cache_to=prompt.shape[1] + LLM_STEPS)
        seq = prompt
        for step in range(LLM_STEPS + 1):
            if step:
                token = last.argmax(-1).to(torch.int32)
                seq = torch.cat([seq, token[:, None]], dim=1)
                cache, last = tf.decode_step(cfg, model, cache,
                                             {"token": token})
            full = tf.forward(cfg, model, {"tokens": seq})[:, -1]
            err, ok = within(last, full, **TOL_BF16)
            errs.append(err)
            if not (ok and bool(torch.isfinite(last).all())):
                raise AssertionError(f"decode step {step}: logits disagree "
                                     "with the full forward")
    lengths = cache["lengths"].tolist()
    print(f"  prefill {tuple(prompt.shape)} and {LLM_STEPS} greedy decode "
          f"steps: max_abs_err against the full forward per step {errs!r}; "
          f"cache {tuple(cache['k'].shape)}, lengths {lengths}", flush=True)
    if lengths != [prompt.shape[1] + LLM_STEPS] * prompt.shape[0]:
        raise AssertionError(f"decode left the cache lengths at {lengths}")
    return {"prompt": list(prompt.shape), "steps": LLM_STEPS,
            "max_abs_err_by_step": errs}


def llm_query(udf, reviews, policy: str) -> tuple:
    """The serving CLI's query (``launch/serve.py::main``) on one policy:
    (report, wall seconds)."""
    from repro_torch.core import Predicate, Query, TrivialPredicate, batches_of
    from repro_torch.core.policies import EDDY_POLICIES, DataAware
    from repro_torch.launch.serve import QueryService, review_source
    pred = Predicate("LLM_is_food", udf, compare=lambda s: s > 0)
    q = Query(source=review_source(reviews), predicates=[pred],
              trivial=[TrivialPredicate("rating", "<=", 1)],
              batch_rows=LLM_ROWS)
    t0 = time.perf_counter()
    with QueryService(max_concurrent=1) as service:
        handle = service.submit(
            [pred], batches_of(q), policy=EDDY_POLICIES[policy](),
            laminar_policy_factory=DataAware, max_workers=4)
        rep = handle.result(timeout=900)
    return rep, time.perf_counter() - t0


RGLRU_SCOPE = "rglru_bsw call"   # the profiler range of a hybrid call
COPY_OPS = ("aten::copy_", "aten::_to_copy", "aten::to", "aten::contiguous",
            "aten::clone")
RGLRU_KERNEL = re.compile(r"rglru_(pipe_)?kernel")
# the CUDA API calls in a trace (cudaLaunchKernel,
# cuLaunchKernelEx, cudaMemcpyAsync ...), which share a correlation id
# with the device work they start
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")
PROFILER_WARM_UP = "profiler warm-up"   # the range of ``warm_up_profiler``


def warm_up_profiler() -> None:
    """Launch a small kernel in a range of its own and wait for it. Called
    first inside a trace that counts kernels: past a process's first
    trace, the profiler drops the first kernel it sees, which may be an
    rglru_bsw call's (on an H100 with torch 2.11; none goes missing with
    this warm-up first). ``warm_up_ids`` names its device work, which the
    counts skip."""
    with torch.profiler.record_function(PROFILER_WARM_UP):
        torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()


def warm_up_ids(events) -> set:
    """The correlation ids of the device work ``warm_up_profiler``
    launched in a trace's ``events``."""
    from torch.autograd import DeviceType
    ranges = [e.time_range for e in events if e.name == PROFILER_WARM_UP
              and e.device_type == DeviceType.CPU]
    return {e.id for e in events if e.device_type == DeviceType.CPU
            and RUNTIME_CALL.match(e.name)
            and any(r.start <= e.time_range.start <= r.end for r in ranges)}


@contextlib.contextmanager
def rglru_scopes():
    """While open, each of the hybrid family's ``rglru_bsw`` calls runs
    inside a profiler range named RGLRU_SCOPE."""
    from repro_torch.models import hybrid
    inner = hybrid.rglru_bsw

    def scoped(*args, **kw):
        with torch.profiler.record_function(RGLRU_SCOPE):
            return inner(*args, **kw)

    hybrid.rglru_bsw = scoped
    try:
        yield
    finally:
        hybrid.rglru_bsw = inner


def rglru_calls(prof):
    """The ``rglru_bsw`` calls of a trace taken under ``rglru_scopes``:
    the device work each call launched (the runtime's calls inside the
    call's host range, joined to the device's kernels and copies by
    correlation id), and the copy and cast operations (COPY_OPS) inside
    its range on the host. Raises unless each call launched one RG-LRU
    kernel, no copy, and shows as one span of the range on the device;
    None where the trace holds no call."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    host = [e for e in events
            if e.name == RGLRU_SCOPE and e.device_type == DeviceType.CPU]
    if not host:
        return None
    spans = [e for e in events
             if e.name == RGLRU_SCOPE and e.device_type == DeviceType.CUDA]
    device = collections.defaultdict(list)   # correlation id -> names
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in (
                RGLRU_SCOPE, "optimizer"):
            device[e.id].append(e.name)
    runtime = [e for e in events if e.device_type == DeviceType.CPU
               and RUNTIME_CALL.match(e.name) and e.id in device]
    per_call = [[n for e in runtime
                 if c.time_range.start <= e.time_range.start
                 <= c.time_range.end for n in device[e.id]] for c in host]
    copies = [e.name for e in events if e.device_type == DeviceType.CPU
              and e.name in COPY_OPS and any(
                  c.thread == e.thread and c.time_range.start
                  <= e.time_range.start <= c.time_range.end for c in host)]
    out = {"calls": len(host), "device_spans": len(spans),
           "kernels_a_call": dict(collections.Counter(map(len, per_call))),
           "kernel_names": sorted({n[:60] for c in per_call for n in c}),
           "copy_ops": len(copies)}
    print(f"  rglru_bsw calls in the trace: {out}", flush=True)
    if len(spans) != len(host) or copies or any(
            len(c) != 1 or not RGLRU_KERNEL.search(c[0]) for c in per_call):
        raise AssertionError(f"an rglru_bsw call made other than one RG-LRU "
                             f"kernel and no copy: {out}")
    return out


def device_trace(fn, data) -> dict:
    """Device time of one call ``fn(data)`` (an LLM call, a model's
    forward) by kernel, from a ``torch.profiler`` trace: the flash, ssd,
    rglru and router launches, the vocabulary GEMM (the call's last GEMM:
    the head's product), the layers' GEMMs, log-softmax, copies and the
    rest; with the hybrid family, its ``rglru_bsw`` calls (``rglru_calls``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(data)
    torch.cuda.synchronize()
    with rglru_scopes(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        warm_up_profiler()
        fn(data)
        torch.cuda.synchronize()
    split, count, by_name, gemms = (collections.Counter(),
                                    collections.Counter(),
                                    collections.Counter(), [])
    events = list(prof.events())
    warm = warm_up_ids(events)
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in (
                RGLRU_SCOPE, PROFILER_WARM_UP) or e.id in warm:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        if "flash" in name:
            key = "flash_attention"
        elif "ssd_kernel" in name or "ssd_fwd_" in name:
            key = "ssd"
        elif RGLRU_KERNEL.search(name):
            key = "rglru"
        elif "moe_router" in name:
            key = "moe_router"
        elif name.startswith(("memcpy", "memset")):
            key = "copies"
        elif "softmax" in name:
            key = "log_softmax"
        elif any(w in name for w in ("gemm", "gemv", "cutlass", "xmma",
                                     "nvjet")):
            key = "layer_gemms"
            gemms.append((e.time_range.start, ms))
        else:
            key = "other"
        split[key] += ms
        count[key] += 1
        by_name[e.name[:100]] += ms
    if gemms:
        last = max(gemms)[1]
        split["layer_gemms"] -= last
        count["layer_gemms"] -= 1
        split["vocab_gemm"], count["vocab_gemm"] = last, 1
    return {"device_ms": sum(split.values()), "kernels": sum(count.values()),
            "split_ms": dict(split), "split_launches": dict(count),
            "top_kernels_ms": dict(by_name.most_common(12)),
            "rglru_calls": rglru_calls(prof)}


def time_llm(cfg, model, udf, toks: np.ndarray, before=None) -> dict:
    """One LLM call at 10 and 64 rows: ms a call on the host clock and
    between CUDA events on its stream (the median of LLM_ROUNDS, each
    ending in the copy back), torch operations a call,
    its device time by kernel, and its parts timed alone with CUDA events:
    the flash kernel at its shape (beside its bound, SDPA and ``before``'s
    entry point, given), the
    vocabulary GEMM, and the float32 log-softmax with the masked pool."""
    from repro_torch.kernels import launch, ref
    from repro_torch.kernels.flash_attention import flash_attention_bshd
    from repro_torch.models.layers import embed_tokens
    dev = torch.device("cuda")
    out = {}
    rng = np.random.default_rng(17)
    for rows in (LLM_ROWS, LLM_ORACLE_ROWS):
        data = {"tokens": toks[:rows]}
        for _ in range(2):
            udf.fn(data)
        times, events = [], []
        for _ in range(LLM_ROUNDS):
            # the call runs on this thread's stream: events there bracket it
            with launch.thread_stream(dev):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                udf.fn(data)
                times.append((time.perf_counter() - t0) * 1e3)
                end.record()
            end.synchronize()
            events.append(start.elapsed_time(end))
        with OpCount() as c:
            udf.fn(data)
        trace = device_trace(udf.fn, data)
        x = torch.from_numpy(data["tokens"]).to(dev)
        qkv = [torch.from_numpy(rng.standard_normal(
            (rows, x.shape[1], n, cfg.head_dim)).astype(np.float32)).to(
                dev, torch.bfloat16) for n in (cfg.num_heads,
                                               cfg.num_kv_heads,
                                               cfg.num_kv_heads)]
        label = (f"llm B={rows} S={x.shape[1]} H={cfg.num_heads} "
                 f"Hkv={cfg.num_kv_heads} D={cfg.head_dim} bf16")
        group = cfg.num_heads // cfg.num_kv_heads
        want = ref.flash_attention_bshd(*qkv)
        flash_err = check_close(
            "flash_attention", flash_attention_bshd(*qkv), want, label,
            tol=ref.flash_bf16_limit(*qkv, want))
        flash = time_flash(*qkv, group=group, causal=True, window=0,
                           label=label, before=before)
        with torch.inference_mode():
            h = embed_tokens(x, model.embed)
            head = model.embed.T
            logits = torch.matmul(h, head)
            mask = (x > 0)[..., None].to(logits.dtype)
            gemm_ms = time_ms(lambda: torch.matmul(h, head), 20)
            pool_ms = time_ms(lambda: (torch.log_softmax(
                logits.to(torch.float32), -1) * mask).sum(1), 20)
        call_ms = float(np.median(times))
        t = {"rows": rows, "call_ms": call_ms, "call_ms_rounds": times,
             "call_event_ms": float(np.median(events)),
             "torch_ops": len(c.ops), "trace": trace,
             "busy_share": trace["device_ms"] / call_ms,
             "flash_label": label, "flash_attention": flash,
             "flash_max_abs_err": flash_err,
             "flash_launches": cfg.num_layers,
             "flash_ms_per_call": cfg.num_layers * flash["entry_ms"],
             "vocab_gemm_ms": gemm_ms,
             "vocab_gemm_gflop": 2.0 * x.numel() * cfg.d_model
             * cfg.vocab_padded / 1e9,
             "log_softmax_pool_ms": pool_ms}
        print(f"  LLM call, {rows} rows: {call_ms!r} ms on the host clock "
              f"(rounds {times!r}), {t['call_event_ms']!r} ms between CUDA "
              f"events on its stream, {len(c.ops)} torch operations; device "
              f"time in one traced call {trace['device_ms']!r} ms over "
              f"{trace['kernels']} kernels (busy share {t['busy_share']!r}), "
              f"split {trace['split_ms']}, launches "
              f"{trace['split_launches']}", flush=True)
        print(f"    top kernels: {trace['top_kernels_ms']}")
        print(f"    alone: {cfg.num_layers} flash launches "
              f"{t['flash_ms_per_call']!r} ms, vocabulary GEMM {gemm_ms!r} "
              f"ms ({t['vocab_gemm_gflop']!r} GFLOP), float32 log-softmax "
              f"and pool {pool_ms!r} ms", flush=True)
        out[str(rows)] = t
    return out


def run_llm(reviews, cfg, model, dev: torch.device) -> dict:
    """The LLM predicate on ``model``: forward and decode checks, then the
    serving CLI's query under every policy against the whole-table
    oracle."""
    from repro_torch.core.policies import EDDY_POLICIES
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.serve import build_llm_udf, review_source
    from repro_torch.models import transformer as tf
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; {tf.param_count(cfg)} parameters drawn on "
          f"{dev} from seed {LLM_SEED}")
    parts = list(review_source(reviews))
    table = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    low = table["rating"] <= 1
    toks, ids = table["tokens"][low], table["_row_id"][low]
    live = (toks > 0).sum(1)
    print(f"  make_reviews({len(reviews)}, seed=0): {len(ids)} rows with "
          f"rating <= 1, {toks.shape[1]} token slots each, {live.min()}.."
          f"{live.max()} live (mean {live.mean():.1f}), 0-padded")
    x = torch.from_numpy(toks[:LLM_ROWS]).to(dev)
    forward = check_llm_forward(cfg, model, x)
    decode = check_llm_decode(cfg, model, x[:, :LLM_PROMPT])

    # the whole-table oracle, through the kernel and the plain attention
    udf = build_llm_udf(params=model, cfg=cfg, device=dev)
    t0 = time.perf_counter()
    s64 = llm_scores(udf.fn, toks, LLM_ORACLE_ROWS)
    s10 = llm_scores(udf.fn, toks, LLM_ROWS)
    with plain_kernels():
        p64 = llm_scores(udf.fn, toks, LLM_ORACLE_ROWS)
    oracle_s = time.perf_counter() - t0
    # cuBLAS need not give a row the same bits in a batch of 10 and of 64;
    # a row whose |score| lies within LLM_MARGIN times the largest such
    # difference may flip between the served batches and the oracle's
    batch_diff = float(np.abs(s10 - s64).max())
    margin = LLM_MARGIN * batch_diff
    sure = np.abs(s64) > margin
    # the plain attention rounds its bf16 outputs at other places: 30
    # layers on, the scores differ by up to plain_diff, so the two
    # oracles' decisions are compared outside LLM_MARGIN times that
    plain_diff = float(np.abs(p64 - s64).max())
    plain_margin = LLM_MARGIN * plain_diff
    differ = (p64 > 0) != (s64 > 0)
    flips = differ & (np.abs(s64) > plain_margin)
    expect = set(ids[s64 > 0].tolist())
    decided = set(ids[sure].tolist())
    print(f"  oracle ({oracle_s:.2f}s): {len(expect)} of {len(ids)} rows "
          f"score > 0; |score| {float(np.abs(s64).min())!r}.."
          f"{float(np.abs(s64).max())!r}; largest score difference between "
          f"batches of {LLM_ROWS} and {LLM_ORACLE_ROWS} {batch_diff!r}, "
          f"margin {LLM_MARGIN} x that = {margin!r} with {int((~sure).sum())}"
          f" rows inside it", flush=True)
    print(f"  oracle through the plain attention: largest score difference "
          f"{plain_diff!r}; {int(differ.sum())} decisions differ (|score| "
          f"{sorted(np.abs(s64[differ]).tolist())!r}); margin {LLM_MARGIN} x "
          f"that = {plain_margin!r} with "
          f"{int((np.abs(s64) <= plain_margin).sum())} rows inside it",
          flush=True)
    if not (np.isfinite(s64).all() and np.isfinite(p64).all()):
        raise AssertionError("the LLM oracle's scores are not finite")
    if flips.any():
        raise AssertionError("the oracle through the plain attention "
                             "disagrees outside its margin")

    # the serving CLI's query under every policy
    runs = {}
    flash_attention.launches = 0
    for policy in sorted(EDDY_POLICIES):
        before = flash_attention.launches
        rep, wall = llm_query(udf, reviews, policy)
        n = flash_attention.launches - before
        got = set(map(int, rep.row_ids))
        wrong = (got ^ expect) & decided
        print(f"  {policy}: {rep.state}, {len(got)} rows in {wall!r} s "
              f"(eval {rep.eval_time_s!r} s, {rep.batches} batches); "
              f"{n} flash launches; board {list(rep.board_predicates)}; "
              f"rows differing from the oracle {len(got ^ expect)}, outside "
              f"the margin {len(wrong)}", flush=True)
        if rep.state != "DONE" or wrong:
            raise AssertionError(f"LLM query, policy {policy}: {rep.state}, "
                                 f"{len(wrong)} rows outside the margin "
                                 f"differ from the oracle: "
                                 f"{sorted(wrong)[:10]}")
        if n <= 0 or n % cfg.num_layers:
            raise AssertionError(f"LLM query, policy {policy}: {n} flash "
                                 "launches, not a positive multiple of "
                                 f"{cfg.num_layers}")
        runs[policy] = {"rows": len(got), "wall_s": wall,
                        "eval_s": rep.eval_time_s, "batches": rep.batches,
                        "flash_launches": n, "llm_calls": n // cfg.num_layers,
                        "differ_inside_margin": len(got ^ expect),
                        "board_predicates": rep.board_predicates}
    launches = flash_attention.launches
    print(f"  flash_attention launches over the {len(runs)} queries: "
          f"{launches}")
    return {"arch": cfg.name, "params": tf.param_count(cfg),
            "rows": len(ids), "forward": forward, "decode": decode,
            "oracle": {"rows_true": len(expect), "batch_diff": batch_diff,
                       "margin": margin, "inside_margin": int((~sure).sum()),
                       "plain_diff": plain_diff, "plain_margin": plain_margin,
                       "plain_decisions_differ": int(differ.sum()),
                       "plain_inside_margin": int(
                           (np.abs(s64) <= plain_margin).sum()),
                       "seconds": oracle_s},
            "query": runs, "launches": launches, "udf": udf, "tokens": toks}


# --------------------------------------------------------------------------- #
# phase 3 at the families' shapes, and phase 10: the model families            #
# --------------------------------------------------------------------------- #
def ptxas_lines(lib_name: str, instance: str) -> list:
    """ptxas' lines (registers, shared memory, spills) for the kernel
    instances whose mangled name holds ``instance``."""
    from repro_torch.kernels import _build
    lines, keep = [], False
    for line in _build.load(lib_name).log.splitlines():
        if "Compiling entry function" in line:
            keep = instance in line
            if keep:
                lines.append(line.split("'")[1])
        elif keep and ("spill" in line or ("ptxas" in line and (
                "registers" in line or "smem" in line))):
            lines.append(line.strip())
    return lines


def kernel_stage_ms(call, pattern: str, calls: int = 10) -> dict:
    """Device ms a call of ``call()`` by kernel, the kernels named by
    ``pattern``'s group, from a torch.profiler trace of ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.events():
        stage = re.search(pattern, e.name)
        if e.device_type == DeviceType.CUDA and stage:
            out[stage.group(1)] += e.time_range.elapsed_us() / 1e3 / calls
    return dict(out)


def time_ssd_case(x, dt, A, Bm, Cm, label: str, mutants=(),
                  before=None) -> dict:
    """ssd at a model's shape (chunk min(64, S), as the scan calls it):
    held against the plain version in float32 (y and h_last within
    TOL_TIGHT) with no h0, as the model calls it, and with one, one count
    a call and the same bits on a rerun; each of SSD_FWD_MUTANTS
    (``mutants``, built) refused by the same rule; then timed through
    ``ssd_bshp`` on the model's bfloat16 x, B and C (the wrapper's three
    float32 copies included) and at the C entry point on the float32
    views, in turns, in a CUDA graph, beside ``before``'s entry point
    (``build_before``'s, given; in turns with this one), the plain version
    on the bfloat16 inputs and the bound (x, dt, A, B, C read once, y and
    h_last written once, in float32; ``ssd.flops`` as 3xTF32 on the tensor
    cores, and on the float32 CUDA cores); each of the call's kernels'
    device time; and the forward kernels' tensor-core instructions in the
    library's SASS (``sass_counts``: TF32 HMMA in the chunk-state and
    per-chunk kernels, no F32 atomics)."""
    from repro_torch.kernels import _build, ref, ssd
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    chunk = min(64, s)
    h0 = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (b, h, p, n)).astype(np.float32)).cuda()
    errs, shares = {}, {}
    for what, init in (("h0", h0), ("no h0", None)):   # the model's last
        counted = ssd.launches
        y, h_last = ssd.ssd_bshp(x, dt, A, Bm, Cm, init, chunk=chunk)
        y2, h2 = ssd.ssd_bshp(x, dt, A, Bm, Cm, init, chunk=chunk)
        y_p, h_p = ref.ssd(x, dt, A, Bm, Cm, init, chunk=chunk)
        torch.cuda.synchronize()
        counted = ssd.launches - counted
        err_y, ok_y = within(y, y_p, **TOL_TIGHT)
        err_h, ok_h = within(h_last, h_p, **TOL_TIGHT)
        share = max(share_of(y, y_p, TOL_TIGHT["atol"]
                             + TOL_TIGHT["rtol"] * y_p.abs()),
                    share_of(h_last, h_p, TOL_TIGHT["atol"]
                             + TOL_TIGHT["rtol"] * h_p.abs()))
        same = torch.equal(y, y2) and torch.equal(h_last, h2)
        print(f"  ssd {label} chunk={chunk}, {what}: y max_abs_err "
              f"{err_y!r}, h_last {err_h!r} (|y| up to "
              f"{float(y_p.abs().max())!r}), largest share of TOL_TIGHT's "
              f"limit {share!r}; bit-equal on a rerun {same}, counted "
              f"{counted} in 2 calls", flush=True)
        if not (ok_y and ok_h and same and counted == 2):
            raise AssertionError(f"ssd kernel disagrees on {label}, {what}")
        errs[what] = max(err_y, err_h)
        shares[what] = share
    del y2, h2, h0
    call = _build.load("ssd").lib.ssd_scan
    y_out, h_out = torch.empty_like(x), torch.empty_like(h_last)  # kept
    args = ssd_view_args(x, dt, A, Bm, Cm, y_out, h_out, chunk)
    scratch = torch.empty(ssd.scratch_floats(b, h, s, p, n, chunk),
                          device="cuda")
    ptr = scratch.data_ptr() if scratch.numel() else None
    stream = torch.cuda.current_stream().cuda_stream
    if call(args, ptr, stream) != 0:
        raise AssertionError("ssd entry point failed")
    torch.cuda.synchronize()
    if not (torch.equal(y_out, y) and torch.equal(h_out, h_last)):
        raise AssertionError("the ssd entry point's result differs")
    refused = {}
    for (what, *_), fn in zip(SSD_FWD_MUTANTS, mutants):
        my, mh = torch.empty_like(x), torch.empty_like(h_last)
        if fn(ssd_view_args(x, dt, A, Bm, Cm, my, mh, chunk), ptr,
              stream) != 0:
            raise AssertionError(f"the ssd mutant that {what} failed")
        torch.cuda.synchronize()
        err_y, ok_y = within(my, y_p, **TOL_TIGHT)
        err_h, ok_h = within(mh, h_p, **TOL_TIGHT)
        refused[what] = {"y_max_abs_err": err_y, "h_last_max_abs_err": err_h,
                         "accepted": ok_y and ok_h}
        print(f"  ssd rule at {label}, the mutant that {what}: y max_abs_err "
              f"{err_y!r}, h_last {err_h!r}; accepted {ok_y and ok_h}",
              flush=True)
        if ok_y and ok_h:
            raise AssertionError(f"the ssd rule accepts the mutant that "
                                 f"{what}")
        del my, mh
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))

    def entry():
        return call(args, ptr, stream)

    t = {
        "dtype": "bfloat16 in, float32 kernel",
        **paired_ms({
            "ms": lambda: ssd.ssd_bshp(xb, dt, A, Bb, Cb, chunk=chunk),
            "entry_ms": entry}, iters=20),
        "graph_ms": graph_ms(lambda st: call(args, ptr, st), n=20, reps=5),
        "plain_ms": time_ms(lambda: ref.ssd(xb, dt, A, Bb, Cb, None,
                                            chunk=chunk), 10),
        "library_ms": None,   # no single PyTorch call scans SSD
        "max_abs_err": max(errs.values()),
        "errors": errs,
        "share_of_limit": shares,
        "mutants": refused,
    }
    if before is not None:   # few calls: an earlier kernel may take tens of ms
        old_args = ssd_view_args(x, dt, A, Bm, Cm, torch.empty_like(x),
                                 torch.empty_like(h_last), chunk)
        old = before["ssd"]
        if old(old_args, ptr, stream) != 0:
            raise AssertionError("the earlier ssd entry point failed")
        pair = paired_ms({"entry_ms": entry,
                          "before_ms": lambda: old(old_args, ptr, stream)},
                         rounds=3, iters=3)
        t["before_ms"] = pair["before_ms"]
        t["entry_ms_beside_before"] = pair["entry_ms"]
    t["stage_ms"] = kernel_stage_ms(entry, r"ssd_fwd_(\w+?)_kernel")
    t.update(tensor_core_bound(
        4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n
             + b * h * p * n), ssd.flops(b, s, h, p, n, chunk),
        torch.float32))
    extra = (f", the earlier source's entry point {t['before_ms']!r} ms "
             f"(this one {t['entry_ms_beside_before']!r} ms beside it)"
             if "before_ms" in t else "")
    print(f"  ssd {label}: kernel {t['ms']!r} ms through the wrapper on "
          f"bfloat16 (entry point on float32 {t['entry_ms']!r} ms, in a "
          f"CUDA graph {t['graph_ms']!r} ms){extra}; device ms a call by "
          f"kernel {t['stage_ms']}; plain {t['plain_ms']!r} ms, bound "
          f"{t['bound_ms']!r} ms ({t['bound_by']}, 3xTF32; float32 CUDA "
          f"cores {t['bound_f32_cores_ms']!r} ms)", flush=True)
    for line in ptxas_lines("ssd", "ssd_"):
        print(f"  ssd (ptxas): {line}")
    sass = sass_counts("ssd")
    for fn, c in sass.items():
        print(f"  ssd (SASS) {fn}: {c}")
    t["hmma_tf32"] = {
        m.group(1) + (f"<{m.group(2)}>" if m.group(2) else ""): c["hmma_tf32"]
        for fn, c in sass.items()
        for m in [re.search(r"(ssd_fwd_[a-z]+_kernel|ssd_kernel)(?:ILi(\d+))?",
                            fn)] if m}
    for stage in ("ssd_fwd_states_kernel", "ssd_fwd_out_kernel"):
        if not t["hmma_tf32"].get(stage):
            raise AssertionError(f"{stage} holds no TF32 HMMA")
    if any(c["f32_atomics"] for c in sass.values()):
        raise AssertionError("the ssd library holds F32 atomics")
    return t


def rglru_term_instructions(listing: str | None = None) -> dict:
    """Warp instructions an element of the pipelined RG-LRU kernel's terms,
    counted in the built SASS (``cuobjdump -sass``) of its bf16 instance
    with 16 term warps: the straight run of ``terms4`` from the last
    branch before its first MUFU.EX2 to its last STS.128 (four elements'
    a_t and m_t, from the widened inputs to the stores), less the block a
    predicated forward branch skips that holds a CALL (the divisions of
    divisors of 2^126 or more, not taken); the run is the first MUFU.EX2
    after the loop's wait on `walked` (its store of the chunk before has
    none). Loads, stores to memory and barriers are left out, so the bound
    drawn from it is a floor."""
    if listing is None:
        from repro_torch.kernels import _build
        tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
        listing = subprocess.run(
            [tool, "-sass", str(_build.load("rglru").path)],
            capture_output=True, text=True, check=True).stdout
    ins, fn = [], None
    for line in listing.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and fn and "rglru_pipe_kernelI13__nv_bfloat16Li16" in fn:
            ins.append((int(m.group(1), 16), m.group(2)))
    ops = [op for _, op in ins]
    rsq = [k for k, op in enumerate(ops) if "MUFU.RSQ" in op]
    # the term loop: its wait on `walked`, the store, then terms4
    wait = max(k for k in range(rsq[0]) if "SYNCS.PHASECHK" in ops[k])
    first = next(k for k in range(wait, rsq[0]) if "MUFU.EX2" in ops[k])
    last_rsq = rsq[-1]
    control = re.compile(r"\b(BRA|BSSY|BSYNC|SYNCS)")
    start = 1 + max(k for k in range(first) if control.search(ops[k]))
    stop = next(k for k in range(last_rsq, len(ops)) if control.search(ops[k]))
    end = max(k for k in range(last_rsq, stop) if ops[k].startswith("STS.128"))
    skipped = set()
    for k in range(start, end + 1):
        br = re.match(r"@!?P\d\s+BRA\s+(?:0x)?([0-9a-f]+)", ops[k])
        if br:
            target = int(br.group(1), 16)
            block = {j for j in range(k + 1, end + 1) if ins[j][0] < target}
            if any("CALL" in ops[j] for j in block):
                skipped |= block
    count = end - start + 1 - len(skipped)
    return {"instructions_4_elements": count, "per_element": count / 4,
            "straight_run": end - start + 1, "slow_block": len(skipped)}


def issue_bound_ms(elements: int, per_element: float) -> float:
    """The terms' issue floor: ``per_element`` thread instructions an
    element, a warp instruction for 32 elements, over the card's 132 SMs x
    4 schedulers at its highest SM clock (``nvidia-smi``)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    return elements * per_element / 32 / (132 * 4 * mhz * 1e6) * 1e3


# (B, S, W) at the route's boundaries: a decode step, the predicates'
# width, a short prefill, one tile, recurrentgemma's forward and train
# step, and a wide batch
RGLRU_ROUTE_SHAPES = ((1, 1, 4096), (32, 64, 16), (4096, 64, 16),
                      (1, 64, 4096), (1, 2560, 32), (1, 2560, 4096),
                      (2, 2560, 4096), (8, 256, 4096))


def rglru_route_cases() -> dict:
    """Each of ``rglru_bsw``'s designs at RGLRU_ROUTE_SHAPES on bf16
    inputs with a bf16 h0, forced at the C entry point and timed in a CUDA
    graph (the device's time, below the host's cost of a call), beside
    the design ``rglru.route`` picks; every design's out and h_last
    bit-equal to the routed one's."""
    from repro_torch.kernels import _build, rglru
    call = _build.load("rglru").lib.rglru_bsw
    rng = np.random.default_rng(29)
    out = {}
    for b, s, w in RGLRU_ROUTE_SHAPES:
        def T(*dims):
            return torch.from_numpy(rng.standard_normal(dims).astype(
                np.float32)).cuda().to(torch.bfloat16)

        x, r, i, a_param, h0 = T(b, s, w), T(b, s, w), T(b, s, w), T(w), \
            T(b, w)
        design = rglru.route(b, s, w)
        want = rglru.rglru_bsw(x, r, i, a_param, h0)
        ms, same = {}, True
        for d in (rglru.STAGED, rglru.PIPELINED, rglru.PIPELINED_PAIRS):
            o, hl = torch.empty_like(x), torch.empty_like(h0)
            args = rglru.pack_args(x, r, i, a_param, h0, o, hl, design=d)
            ms[d] = graph_ms(lambda st: call(args, st), n=20, reps=5)
            torch.cuda.synchronize()
            same = same and torch.equal(o, want[0]) and torch.equal(
                hl, want[1])
        label = f"B={b} S={s} W={w}"
        out[label] = {"route": design, "graph_ms": ms, "bit_equal": same}
        print(f"  rglru designs at {label} bf16, ms a launch in a CUDA graph "
              f"(0 staged, 1 pipelined, 2 pipelined two CTAs an SM): {ms}; "
              f"route {design}; bit-equal {same}", flush=True)
        if not same:
            raise AssertionError(f"rglru's designs disagree at {label}")
    return out


RGLRU_PAIRS = 10   # alternating rounds of the entry beside the parent's


def time_rglru_case(x, r, i, a_param, h0, label: str, keep_hs=False,
                    terms=None, before=None) -> dict:
    """rglru at a model's shape, on the model's bf16 tensors (x, r, i,
    a_param and h0 rounded once from the float32 draws, as the hybrid
    family holds them): ``rglru_bsw`` against ``ref.rglru`` bit for bit in
    float32 and bf16, the bf16 instance bit-equal to the float32 instance
    cast to bf16 and on a rerun, with ``keep_hs`` the float32 h sequence
    the same launch writes (``Rglru.forward``'s) equal to the float32
    instance's output; the design ``rglru.route`` picks; then timed
    through the wrapper as the main path calls it (with ``keep_hs``
    through the autograd function, inputs requiring a gradient), at the
    bf16 and float32 C entry points, in turns, each entry point in a
    CUDA graph, and the plain version.
    Given ``before`` (``build_before``'s), the parent's entry point on
    this one's bf16 and float32 arguments (into buffers of its own),
    every output bit-equal to this one's, its bf16 call (``before_ms``)
    beside this one's in RGLRU_PAIRS alternating pairs and in a CUDA
    graph. Bounds: bytes (x, r, i, a_param, h0 read once, out
    and h_last written once in bf16, hs in float32) against
    ``rooflines.rglru``'s flops at the float32 rate, and the terms' issue
    floor from ``terms`` (``rglru_term_instructions``)."""
    from repro_torch.kernels import _build, ref, rglru
    from repro_torch.udfs import rooflines
    b, s, w = x.shape
    bf16 = torch.bfloat16
    bf = [t.to(bf16) for t in (x, r, i)]
    ab = a_param.to(bf16)
    h0b = None if h0 is None else h0.to(bf16)
    wide = [t.float() for t in bf]
    ab32, h032 = ab.float(), None if h0b is None else h0b.float()
    err = max(check_rglru(*wide, ab32, h032, f"{label} float32"),
              check_rglru(*bf, ab, h0b, f"{label} bfloat16"))
    got16 = rglru.rglru_bsw(*bf, ab, h0b)
    again = rglru.rglru_bsw(*bf, ab, h0b)
    got32 = rglru.rglru_bsw(*wide, ab32, h032)
    same = {"rerun": all(torch.equal(g, a) for g, a in zip(got16, again)),
            "float32_cast": all(torch.equal(g, f.to(bf16))
                                for g, f in zip(got16, got32))}
    if keep_hs:
        out, h_last, hs = rglru._forward(*bf, ab, h0b, 8.0, keep_hs=True)
        same["hs_is_float32_instance"] = (
            hs.dtype == torch.float32 and torch.equal(hs, got32[0])
            and torch.equal(out, got16[0]) and torch.equal(h_last, got16[1]))
        del out, h_last, hs
    torch.cuda.synchronize()
    design = rglru.route(b, s, w)
    print(f"  rglru {label}: design {design} ({rglru.DESIGNS[design]}); "
          f"bf16 instance bit-equal {same}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"rglru {label}: the bf16 instance disagrees "
                             f"{same}")
    o16, hl16 = torch.empty_like(bf[0]), torch.empty((b, w), dtype=bf16,
                                                     device=x.device)
    hs_buf = torch.empty_like(x) if keep_hs else None
    o32, hl32 = torch.empty_like(x), torch.empty((b, w), device=x.device)
    args16 = rglru.pack_args(*bf, ab, h0b, o16, hl16, hs_buf)
    args32 = rglru.pack_args(*wide, ab32, h032, o32, hl32)
    call = _build.load("rglru").lib.rglru_bsw
    stream = torch.cuda.current_stream().cuda_stream
    if call(args16, stream) != 0 or call(args32, stream) != 0:
        raise AssertionError("rglru entry point failed")
    leaves = [t.clone().requires_grad_(keep_hs) for t in bf]

    def wrapper():
        with torch.enable_grad():
            return rglru.rglru_bsw(*leaves, ab, h0b)

    fns = {"ms": wrapper, "entry_ms": lambda: call(args16, stream),
           "f32_entry_ms": lambda: call(args32, stream)}
    launches = rglru.launches
    t = {"dtype": "bfloat16 in and out (the bf16 instance)",
         "design": design, "keeps_hs": keep_hs, **paired_ms(fns, iters=20),
         "graph_ms": graph_ms(lambda st: call(args16, st), n=20, reps=5),
         "f32_graph_ms": graph_ms(lambda st: call(args32, st), n=20, reps=5),
         "plain_ms": time_ms(lambda: ref.rglru(*bf, ab, h0b),
                             3 if s > 64 else TIME_ITERS, warmup=1),
         "library_ms": None,   # no single PyTorch call scans RG-LRU
         "max_abs_err": err, "bit_equal": same}
    if before is not None:
        # the parent's entry on this source's arguments, into buffers of
        # its own
        old = before["rglru"][0]
        mine = [o16, hl16, o32, hl32] + ([hs_buf] if keep_hs else [])
        theirs = [torch.empty_like(u) for u in mine]
        old16 = rglru.pack_args(*bf, ab, h0b, *theirs[:2],
                                theirs[4] if keep_hs else None)
        old32 = rglru.pack_args(*wide, ab32, h032, *theirs[2:4])
        if old(old16, stream) != 0 or old(old32, stream) != 0:
            raise AssertionError("the parent's rglru entry point failed")
        torch.cuda.synchronize()
        t["bit_equal_to_parent"] = all(torch.equal(m, o)
                                       for m, o in zip(mine, theirs))
        if not t["bit_equal_to_parent"]:
            raise AssertionError(f"rglru {label}: this entry differs from "
                                 "the parent's on the same arguments")
        pairs = paired_times({"entry_ms": lambda: call(args16, stream),
                              "before_ms": lambda: old(old16, stream)},
                             rounds=RGLRU_PAIRS, iters=20)
        t["pairs"] = pairs
        t["pairs_won"] = sum(n < o for n, o in zip(pairs["entry_ms"],
                                                   pairs["before_ms"]))
        t["before_ms"] = float(np.median(pairs["before_ms"]))
        t["entry_ms_beside_before"] = float(np.median(pairs["entry_ms"]))
        t["before_graph_ms"] = graph_ms(lambda st: old(old16, st), n=20,
                                        reps=5)
    rglru.launches = launches   # timing calls do not count
    small = w + (0 if h0 is None else b * w) + b * w   # a_param, h0, h_last
    t.update(zip(("bound_ms", "bound_by"), bound_ms(
        2 * (4 * b * s * w + small) + (4 * b * s * w if keep_hs else 0),
        b * rooflines.rglru(s, w).flops_per_row)))
    t["f32_entry_bound_ms"] = bound_ms(
        4 * (4 * b * s * w + small), b * rooflines.rglru(s, w).flops_per_row)[0]
    if terms is not None:
        t["issue_bound_ms"] = issue_bound_ms(b * s * w, terms["per_element"])
    extra = (f"; the parent's bf16 entry point {t['before_ms']!r} ms "
             f"beside this one's {t['entry_ms_beside_before']!r} (won "
             f"{t['pairs_won']} of {RGLRU_PAIRS} pairs), in a CUDA graph "
             f"{t['before_graph_ms']!r} (both instances' outputs bit-equal "
             f"to this one's)" if "before_ms" in t else "")
    issue = (f", the terms' issue floor {t['issue_bound_ms']!r} ms"
             if "issue_bound_ms" in t else "")
    print(f"  rglru {label}: {t['ms']!r} ms through the wrapper "
          f"({'autograd, h sequence kept' if keep_hs else 'no grad'}); bf16 "
          f"entry point {t['entry_ms']!r} ms, in a CUDA graph "
          f"{t['graph_ms']!r}, float32 {t['f32_entry_ms']!r} ms (in a CUDA "
          f"graph {t['f32_graph_ms']!r}); plain {t['plain_ms']!r} ms; bound {t['bound_ms']!r} ms "
          f"({t['bound_by']}; float32 entry {t['f32_entry_bound_ms']!r})"
          f"{issue}{extra}", flush=True)
    return t


def rglru_parent_cases(inputs: TextInputs, before) -> dict:
    """``rglru_tokens`` on the predicates' ids and tables (the first 16
    and BIG rows, with no h0 and with a zero one) and ``rglru_bsw`` in
    float32 on the gathered rows, each against the parent's entry point
    (``build_before``'s) on the same arguments: bit-equal."""
    from repro_torch.kernels import rglru
    old_bsw, old_tokens = before["rglru"]
    tables, a_param = inputs.rglru[:3], inputs.rglru[3]
    stream = torch.cuda.current_stream().cuda_stream
    v, w = tables[0].shape
    out = {}
    for b in (16, BIG):
        ids = inputs.toks[:b]
        x, r, i, _, zero = inputs.rglru_args(b)
        for h0 in (None, zero):
            o, hl = torch.empty((b, SEQ, w), device="cuda"), torch.empty(
                (b, w), device="cuda")
            ptr = 0 if h0 is None else h0.data_ptr()
            old_tokens(rglru.TOKENS_ARGS.pack(
                ids.data_ptr(), *(t.data_ptr() for t in tables),
                a_param.data_ptr(), ptr, o.data_ptr(), hl.data_ptr(), b, SEQ,
                w, v, 8.0, 0), stream)
            ob, hb = torch.empty_like(o), torch.empty_like(hl)
            old_bsw(rglru.pack_args(x, r, i, a_param, h0, ob, hb), stream)
            got = rglru.rglru_tokens(ids, *tables, a_param, h0)
            got_bsw = rglru.rglru_bsw(x, r, i, a_param, h0)
            torch.cuda.synchronize()
            label = f"B={b} h0 {'None' if h0 is None else 'zero'}"
            out[label] = {
                "rglru_tokens": torch.equal(got[0], o)
                and torch.equal(got[1], hl),
                "rglru_bsw_float32": torch.equal(got_bsw[0], ob)
                and torch.equal(got_bsw[1], hb)}
    print(f"  rglru_tokens and the float32 rglru_bsw at the predicates' "
          f"shapes, bit-equal to the parent's entry points: {out}",
          flush=True)
    if not all(v for case in out.values() for v in case.values()):
        raise AssertionError("rglru differs from the parent's kernel at the "
                             "predicates' shapes")
    return out


# the RG-LRU gradient at recurrentgemma-9b's training shape (B, S, W), and
RGLRU_BWD_SHAPE = (2, 2560, 4096)


def rglru_bwd_cases(before=None) -> dict:
    """Phase 3 for the RG-LRU gradient kernel at RGLRU_BWD_SHAPE (inputs
    from a numpy seed; channel 1's clamp of 1 - a^2 binds): without h0
    and a cotangent of h_last, then with both, ``rglru.rglru_bwd`` against
    ``ref.rglru_bwd`` on the card (dx, dr, di, da_param, dh0 within
    TOL_TIGHT) and bit-equal on a rerun (no atomics); its bf16 instance
    (bf16 x, r, i, dout in, bf16 dx, dr, di out) bit-equal to the float32
    instance on the same values with dx, dr, di cast to bf16; then timed
    as the main path calls it (``Rglru.backward``: the wrapper on the
    model's bf16 x, r, i and dout and the float32 h, straight through the
    bf16 instance), at the bf16 and float32 C entry points, in turns, and
    given ``before`` (``build_before``'s entry points) the parent's bf16
    entry point on the same arguments (``before_ms``; dx, dr, di and dL
    bit-equal to this one's); the bf16 entry point in a
    CUDA graph; and the plain version. Two bounds, each with a_param, h0,
    dh_last, dh0 and dL and ``rglru.BWD_FLOPS`` a (t, w): the main path's
    (``bound_ms``: x, r, i and dout read once in bfloat16, h in float32,
    dx, dr, di written once in bfloat16) and the float32 entry point's
    (``entry_bound_ms``: the eight arrays in float32). Returns {label:
    timings}."""
    from repro_torch.kernels import _build, ref, rglru
    b, s, w = RGLRU_BWD_SHAPE
    rng = np.random.default_rng(23)

    def T(*dims):
        return torch.from_numpy(rng.standard_normal(dims).astype(
            np.float32)).cuda()

    x, r, i, dout = T(b, s, w), T(b, s, w), T(b, s, w), T(b, s, w)
    a_param = T(w)
    a_param[1] = -40.0
    names = ("dx", "dr", "di", "da_param", "dh0")
    call = _build.load("rglru_bwd").lib.rglru_bwd
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for h0, dh_last in ((None, None), (T(b, w), T(b, w))):
        label = (f"recurrentgemma-9b train B={b} S={s} W={w} h0 and h_last "
                 f"cotangent {'given' if h0 is not None else 'None'}")
        hs, _ = rglru.rglru_bsw(x, r, i, a_param, h0)
        got = rglru.rglru_bwd(x, r, i, a_param, h0, hs, dout, dh_last)
        again = rglru.rglru_bwd(x, r, i, a_param, h0, hs, dout, dh_last)
        want = ref.rglru_bwd(x, r, i, a_param, h0, hs, dout, dh_last)
        bf = [t.to(torch.bfloat16) for t in (x, r, i, dout)]
        g16 = rglru.rglru_bwd(*bf[:3], a_param, h0, hs, bf[3], dh_last)
        g32 = rglru.rglru_bwd(*(t.float() for t in bf[:3]), a_param, h0, hs,
                              bf[3].float(), dh_last)
        torch.cuda.synchronize()
        err, ok, same, exact = 0.0, True, True, {}
        for name, g, a, wt in zip(names, got, again, want):
            if wt is None:
                ok = ok and g is None
                continue
            e, o = within(g, wt, **TOL_TIGHT)
            err, ok, same = max(err, e), ok and o, same and torch.equal(g, a)
            exact[name] = torch.equal(g, wt)
        cast = {name: (g is None and f is None) or (
            g.dtype == (torch.bfloat16 if name in names[:3] else torch.float32)
            and torch.equal(g, f.to(g.dtype)))
            for name, g, f in zip(names, g16, g32)}
        print(f"  rglru_bwd {label}: max_abs_err {err!r} within TOL_TIGHT "
              f"{ok}, bit-equal to the plain version {exact}, bit-equal on "
              f"a rerun {same}; the bf16 instance bit-equal to the float32 "
              f"one cast {cast}", flush=True)
        if not (ok and same and all(cast.values())):
            raise AssertionError(f"the RG-LRU gradient kernel disagrees on "
                                 f"{label}")
        dh0 = None if h0 is None else torch.empty_like(h0)
        part, dl = torch.empty((b, w), device="cuda"), torch.empty(
            w, device="cuda")

        def pack(ins, outs, bf16):
            ptrs = (*ins[:3], a_param, h0, hs, ins[3], dh_last, *outs, dh0,
                    part, dl)
            return rglru.BWD_ARGS.pack(*(0 if t is None else t.data_ptr()
                                         for t in ptrs), b, s, w, 8.0, bf16,
                                       0)

        f32_outs = [torch.empty_like(x) for _ in range(3)]
        bf_outs = [torch.empty_like(bf[0]) for _ in range(3)]
        f32_args = pack((x, r, i, dout), f32_outs, 0)
        bf_args = pack(bf, bf_outs, 1)
        if call(f32_args, stream) != 0 or call(bf_args, stream) != 0:
            raise AssertionError("rglru_bwd entry point failed")
        fns = {"ms": lambda: rglru.rglru_bwd(*bf[:3], a_param, h0, hs, bf[3],
                                             dh_last),
               "entry_ms": lambda: call(bf_args, stream),
               "f32_entry_ms": lambda: call(f32_args, stream)}
        if before is not None:   # the parent's entry: the same arguments
            old = before["rglru_bwd"]
            mine = [g.clone() for g in bf_outs] + [dl.clone()]
            old_outs = [torch.empty_like(bf[0]) for _ in range(3)]
            old_args = pack(bf, old_outs, 1)
            if old(old_args, stream) != 0:
                raise AssertionError("the parent's rglru_bwd entry failed")
            torch.cuda.synchronize()
            if not all(torch.equal(m, o) for m, o in zip(
                    mine, [*old_outs, dl])):
                raise AssertionError(f"rglru_bwd {label}: the bf16 instance "
                                     "differs from the parent's")
            fns["before_ms"] = lambda: old(old_args, stream)
        launches_before = rglru.backward_launches
        t = {"dtype": "bfloat16 in and out (the bf16 instance)",
             **paired_ms(fns, iters=20),
             "graph_ms": graph_ms(lambda st: call(bf_args, st), n=20, reps=5),
             "plain_ms": time_ms(lambda: ref.rglru_bwd(
                 x, r, i, a_param, h0, hs, dout, dh_last), 2, warmup=1),
             "library_ms": None,   # no single PyTorch call differentiates it
             "max_abs_err": err, "bit_equal_to_plain": exact,
             "bf16_bit_equal_to_f32_cast": cast}
        rglru.backward_launches = launches_before   # timing calls do not count
        small_bytes = 4 * (2 * w + (0 if h0 is None else 3 * b * w))
        flops = rglru.BWD_FLOPS * b * s * w
        t.update(zip(("bound_ms", "bound_by"), bound_ms(
            (2 * 7 + 4) * b * s * w + small_bytes, flops)))
        t.update(zip(("entry_bound_ms", "entry_bound_by"), bound_ms(
            4 * 8 * b * s * w + small_bytes, flops)))
        extra = (f"; the parent's bf16 entry point {t['before_ms']!r} ms "
                 f"(dx, dr, di and dL bit-equal to this one's)"
                 if "before_ms" in t else "")
        print(f"  rglru_bwd {label}: {t['ms']!r} ms as the main path calls "
              f"it, bfloat16 in and out (bound {t['bound_ms']!r} ms, "
              f"{t['bound_by']}); bf16 entry point {t['entry_ms']!r} ms, in "
              f"a CUDA graph {t['graph_ms']!r}; float32 entry point "
              f"{t['f32_entry_ms']!r} ms (bound {t['entry_bound_ms']!r} ms, "
              f"{t['entry_bound_by']}){extra}; plain {t['plain_ms']!r} ms",
              flush=True)
        out[label] = t
    for line in ptxas_lines("rglru_bwd", "rglru_bwd"):
        print(f"  rglru_bwd (ptxas): {line}")
    return out


# the SSD gradient's cases: label, (B, S, H, P, G, N), an h0 and a cotangent
# of h_last, x and dy as strided (B, S, H, P) views (every other head-dim
# block of wider tensors, as the model's x is a slice of the conv output)
SSD_BWD_CASES = (
    ("mamba2-370m train (4, 512, 32, 64, G 1, N 128)",
     (4, 512, 32, 64, 1, 128), False, False),
    ("predicate P = N = 4 (16, 64, 2, 4, G 1, N 4)", (16, 64, 2, 4, 1, 4),
     False, False),
    ("G = 2, h0, h_last cotangent, strided (2, 512, 8, 64, G 2, N 128)",
     (2, 512, 8, 64, 2, 128), True, True),
)
SSD_BWD_SEED = 23
SSD_BWD_PAIRS = 10   # rounds of the entry point beside the earlier kernel


def scaled_share(got, want) -> tuple:
    """(max abs error, its largest share of the limit 1e-4 |want| + 1e-5
    max |want|): the SSD gradient's float32 rule. dt's gradient is a
    difference of large terms, and at mamba2's widths every gradient sums
    ~100 terms that cancel: the float32 plain version itself misses
    TOL_TIGHT against a float64 evaluation on a few hundred elements."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    lim = 1e-4 * want.abs() + 1e-5 * want.abs().max()
    return float(err.max()), float((err / lim).max())


def tight_misses(got, want) -> int:
    """Elements of ``got`` outside TOL_TIGHT of ``want``."""
    got, want = got.double(), want.double()
    lim = TOL_TIGHT["atol"] + TOL_TIGHT["rtol"] * want.abs()
    return int(((got - want).abs() > lim).sum())


SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def ssd_bwd_gate(got, want, exact) -> dict:
    """Phase 3's rule for the SSD gradient: every gradient in ``got``
    within ``scaled_share``'s limit of ``want`` (``ref.ssd_bwd``), and its
    share against ``exact`` (float64) no more than twice the plain
    version's, or 0.1; None where ``want`` is None. Returns the errors,
    shares, float64 shares and elements outside TOL_TIGHT of float64 (the
    kernel's, then the plain version's), and ``ok``."""
    err, share, f64, ok = {}, {}, {}, True
    for name, gt, w, w64 in zip(SSD_BWD_NAMES, got, want, exact):
        if w is None:
            ok = ok and gt is None
            continue
        err[name], share[name] = scaled_share(gt, w)
        f64[name] = (scaled_share(gt, w64)[1], scaled_share(w, w64)[1],
                     tight_misses(gt, w64), tight_misses(w, w64))
        ok = ok and share[name] <= 1.0 and (
            f64[name][0] <= max(0.1, 2 * f64[name][1]))
    return {"errors": err, "share_of_limit": share, "float64_shares": f64,
            "ok": ok}


# csrc/ssd_bwd.cu's add of a CTA's earlier heads' dB and dC to a head's
HEADS_SUM_LINE = "  if (add) {\n"

# phase 3's checks of the SSD rules: the forward and its gradient built
# with one line broken (what it breaks, the line, its replacement, and the
# header of csrc/ it lies in, or None for the source itself), which each
# rule must refuse at mamba2's shape
SSD_FWD_MUTANTS = (
    ("drops the split's two correction products (1xTF32)", SSD_SPLIT_LINE,
     "", "ssd_stages.cuh"),
)
SSD_BWD_MUTANTS = SSD_FWD_MUTANTS + (
    ("keeps only the last of a CTA's heads in its partials of dB and dC",
     HEADS_SUM_LINE, "  if (false) {\n", None),
)


def build_ssd_mutants(name: str, mutants: tuple, entry: str) -> list:
    """The entry points of ``name`` built with each of ``mutants`` applied
    (to the source or to the header the mutant names), in a temporary
    directory a mutant (removed once they are loaded)."""
    fns = []
    for i, (_, line, new, header) in enumerate(mutants):
        with tempfile.TemporaryDirectory() as tmp:
            fns.append(build_variant(name, line, new,
                                     os.path.join(tmp, f"{name}_mutant{i}.cu"),
                                     entry, header=header))
    return fns


def sass_counts(lib_name: str) -> dict:
    """Per kernel of a built library, from ``cuobjdump -sass``: its
    tensor-core instructions (``HMMA`` on TF32 operands, and ``HGMMA``) and
    its floating-point atomics (``RED`` / ``ATOM`` on F32)."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    listing = subprocess.run([tool, "-sass", str(_build.load(lib_name).path)],
                             capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
    for line in listing.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"hmma_tf32": 0, "hgmma": 0, "f32_atomics": 0}
            continue
        m = op.search(line)
        if fn is None or m is None:
            continue
        name = m.group(1)
        c = counts[fn]
        c["hmma_tf32"] += name.startswith("HMMA") and "TF32" in name
        c["hgmma"] += name.startswith("HGMMA")
        c["f32_atomics"] += name.startswith(("RED", "ATOM")) and "F32" in name
    return counts


def ssd_bwd_cases(mutants: list, before=None) -> dict:
    """Phase 3 for the SSD gradient kernel at SSD_BWD_CASES (float32
    inputs from a numpy seed: dt a softplus, A negative): ``ssd.ssd_bwd``
    against ``ref.ssd_bwd`` on the card by ``ssd_bwd_gate`` (every
    gradient within the limit of ``scaled_share``; against ``ref.ssd_bwd``
    in float64, the kernel's shares no worse than twice the plain
    version's, or under 0.1), the same bits on a rerun (no atomics); at
    mamba2's shape each of SSD_BWD_MUTANTS refused by the same rule; the
    partials of dB and dC a (b, s) the entry point writes
    (``ssd_bwd_parts``) those ``ssd.cta_heads`` sizes the scratch for;
    then timed through the wrapper and at its C entry point in
    SSD_BWD_PAIRS rounds that take them in turns (and beside ``before``'s
    entry point, ``build_before``'s, given: dx, ddt, dA and dh0 bit-equal
    to its, dB and dC too where a CTA takes one head (K = 1) and else the
    earlier kernel's held to the same rule, the pairs the entry point
    wins and the spread of the earlier kernel's rounds, and at mamba2's
    shape each stage's device time beside), and in a CUDA graph, beside
    its bound (x, dt, A, B, C, dy, h0, dh_last read once, the six
    gradients written once, in float32; ``ssd.bwd_flops`` as 3xTF32 on
    the tensor cores, and on the float32 CUDA cores) and the plain
    versions: torch's autograd through ``ref.ssd`` (the backward pass of
    a recorded graph) and ``ref.ssd_bwd``, the closed form, and at
    mamba2's shape each kernel's device time (``kernel_stage_ms``). No
    single PyTorch call differentiates the scan. Last, the library's
    tensor-core instructions and floating-point atomics by kernel
    (``sass_counts``): the chunk-state and per-chunk kernels must hold
    TF32 HMMA, and no kernel an F32 atomic. Returns {"cases": {label:
    timings}, "mutants", "sass"}."""
    from repro_torch.kernels import _build, ref, ssd
    lib = _build.load("ssd_bwd").lib
    call = lib.ssd_bwd
    stream = torch.cuda.current_stream().cuda_stream
    out = {"cases": {}, "mutants": {}}
    for label, (b, s, h, p, g, n), extras, strided in SSD_BWD_CASES:
        chunk = min(64, s)
        rng = np.random.default_rng(SSD_BWD_SEED)

        def T(*dims):
            return torch.from_numpy(rng.standard_normal(dims).astype(
                np.float32)).cuda()

        def heads(*dims):   # (B, S, H, P), every other block of a wider one
            return T(*dims[:3], 2 * dims[3])[..., :dims[3]] if strided \
                else T(*dims)

        x = heads(b, s, h, p)
        dt = F.softplus(T(b, s, h) - 1.0)
        A = -torch.exp(T(h))
        Bm, Cm = T(b, s, g, n), T(b, s, g, n)
        dy = heads(b, s, h, p)
        h0 = T(b, h, p, n) if extras else None
        dh_last = T(b, h, p, n) if extras else None
        args = (x, dt, A, Bm, Cm, h0, dy, dh_last)
        launches_before = ssd.backward_launches
        got = ssd.ssd_bwd(*args, chunk=chunk)
        again = ssd.ssd_bwd(*args, chunk=chunk)
        want = ref.ssd_bwd(*args, chunk=chunk)
        exact = ref.ssd_bwd(*(None if t is None else t.double()
                              for t in args), chunk=chunk)
        torch.cuda.synchronize()
        gate = ssd_bwd_gate(got, want, exact)
        same = all((gt is None and a is None) or torch.equal(gt, a)
                   for gt, a in zip(got, again))
        print(f"  ssd_bwd {label} chunk {chunk}: max_abs_err "
              f"{gate['errors']}, share of the limit "
              f"{gate['share_of_limit']} (|ddt| up to "
              f"{float(want[1].abs().max())!r}); against float64 (the "
              f"kernel's and the plain version's shares, then their "
              f"elements outside TOL_TIGHT) {gate['float64_shares']}; "
              f"within the limits {gate['ok']}, bit-equal on a rerun "
              f"{same}", flush=True)
        if not (gate["ok"] and same):
            raise AssertionError(f"the SSD gradient kernel disagrees on "
                                 f"{label}")

        # the entry point on buffers of its own, as ssd_bwd packs them
        nc = s // chunk

        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device="cuda")

        # the heads a CTA of the per-chunk stage takes, and the partials of
        # dB and dC a (b, s) this source's call writes (the earlier
        # source's: one a head)
        k = ssd.cta_heads(b, s, h, g, chunk)
        parts = lib.ssd_bwd_parts(b, s, h, g, chunk)
        if parts != h // k:
            raise AssertionError(f"ssd_bwd_parts gives {parts} partials, "
                                 f"ssd.cta_heads {h // k}")

        def entry_args(parts=parts):
            bufs = (empty(b, s, h, p), empty(b, s, h), empty(h),
                    empty(b, s, g, n), empty(b, s, g, n),
                    None if h0 is None else empty(b, h, p, n),
                    empty(b, h, nc, p, n), empty(b, h, nc, p, n),
                    empty(b, h, s), empty(b, s, parts, n),
                    empty(b, s, parts, n), empty(b, h, nc))
            return bufs, ssd.BWD_ARGS.pack(
                *(0 if t is None else t.data_ptr()
                  for t in (x, dt, A, Bm, Cm, h0, dy, dh_last, *bufs)),
                *x.stride(), *dt.stride(), *Bm.stride(), *Cm.stride(),
                *dy.stride(), b, h, s, p, g, n, chunk, 0)

        bufs, packed = entry_args()
        if call(packed, stream) != 0:
            raise AssertionError("ssd_bwd entry point failed")
        torch.cuda.synchronize()
        if not torch.equal(bufs[0], got[0]):
            raise AssertionError("the ssd_bwd entry point's dx differs")
        if label == SSD_BWD_CASES[0][0]:   # mamba2's training shape
            for (what, *_), fn in zip(SSD_BWD_MUTANTS, mutants):
                mbufs, margs = entry_args()
                if fn(margs, stream) != 0:
                    raise AssertionError(f"the SSD gradient mutant that "
                                         f"{what} failed")
                torch.cuda.synchronize()
                m = ssd_bwd_gate(mbufs[:6], want, exact)
                out["mutants"][what] = m
                print(f"  ssd_bwd rule at {label}, the mutant that {what}: "
                      f"share of the limit {m['share_of_limit']}, against "
                      f"float64 {m['float64_shares']}; accepted {m['ok']}",
                      flush=True)
                if m["ok"]:
                    raise AssertionError(f"the SSD gradient rule accepts "
                                         f"the mutant that {what}")
                del mbufs
        fns = {"ms": lambda: ssd.ssd_bwd(*args, chunk=chunk),
               "entry_ms": lambda: call(packed, stream)}
        if before is not None:
            old_bufs, old_packed = entry_args(parts=h)
            old = before["ssd_bwd"]
            if old(old_packed, stream) != 0:
                raise AssertionError("the earlier ssd_bwd entry point failed")
            torch.cuda.synchronize()
            bits = [u is None and v is None or torch.equal(u, v)
                    for u, v in zip(old_bufs[:6], bufs[:6])]
            old_gate = ssd_bwd_gate(old_bufs[:6], want, exact)
            print(f"  ssd_bwd {label}: K {k}; (dx, ddt, dA, dB, dC, dh0) "
                  f"bit-equal to the earlier source's {bits}; the earlier "
                  f"kernel's share of the limit "
                  f"{old_gate['share_of_limit']}", flush=True)
            # dB and dC are summed over the heads in another order where a
            # CTA takes several
            if not all(bits[i] for i in (0, 1, 2, 5)) or (
                    k == 1 and not all(bits)):
                raise AssertionError("the SSD gradient's bits moved")
            if not old_gate["ok"]:
                raise AssertionError("the earlier SSD gradient misses the "
                                     "rule")
            fns["before_ms"] = lambda: old(old_packed, stream)
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, dt, A, Bm, Cm) + (() if h0 is None else (h0,))]
        y, last = ref.ssd(*leaves[:5], leaves[5] if extras else None,
                          chunk=chunk)
        outs, cots = ([y, last], [dy, dh_last]) if extras else ([y], [dy])

        def autograd_plain():
            return torch.autograd.grad(outs, leaves, cots, retain_graph=True)

        rounds = paired_times(fns, rounds=SSD_BWD_PAIRS, iters=10)
        t = {"dtype": "float32",
             **{name: float(np.median(v)) for name, v in rounds.items()},
             "graph_ms": graph_ms(lambda st: call(packed, st), n=10, reps=5),
             "plain_ms": time_ms(autograd_plain, 3, warmup=1),
             "closed_form_ms": time_ms(lambda: ref.ssd_bwd(
                 *args, chunk=chunk), 3, warmup=1),
             "library_ms": None,   # no single PyTorch call differentiates it
             "max_abs_err": max(gate["errors"].values()),
             "errors": gate["errors"],
             "share_of_limit": gate["share_of_limit"],
             "float64_shares": gate["float64_shares"]}
        t["cta_heads"] = k
        if before is not None:
            # the pairs the entry point wins against the earlier kernel's,
            # and the spread of the earlier kernel's own rounds
            q1, q3 = np.percentile(rounds["before_ms"], [25, 75])
            t["pairs_won"] = sum(e < o for e, o in zip(rounds["entry_ms"],
                                                       rounds["before_ms"]))
            t["before_iqr_ms"] = float(q3 - q1)
            print(f"  ssd_bwd {label}: entry ms by round "
                  f"{rounds['entry_ms']}, the earlier kernel's "
                  f"{rounds['before_ms']}; won {t['pairs_won']} of "
                  f"{SSD_BWD_PAIRS} pairs, the earlier kernel's rounds' "
                  f"quartiles {float(q3 - q1)!r} ms apart", flush=True)
        if label == SSD_BWD_CASES[0][0]:
            t["stage_ms"] = kernel_stage_ms(
                lambda: ssd.ssd_bwd(*args, chunk=chunk),
                r"ssd_bwd_(\w+?)_kernel")
            if before is not None:
                t["before_stage_ms"] = kernel_stage_ms(
                    lambda: old(old_packed, stream),
                    r"ssd_bwd_(\w+?)_kernel")
            print(f"  ssd_bwd {label}: device ms a call by kernel "
                  f"{t['stage_ms']}"
                  + (f", the earlier kernel's {t['before_stage_ms']}"
                     if before is not None else ""), flush=True)
        del leaves, y, last, outs, bufs, exact
        if before is not None:
            del old_bufs
        ssd.backward_launches = launches_before   # checks and timing
        # x, dy, dx; dt, ddt; B, C, dB, dC; A, dA; h0, dh_last, dh0
        nbytes = 4 * (3 * b * s * h * p + 2 * b * s * h + 4 * b * s * g * n
                      + 2 * h + (3 * b * h * p * n if extras else 0))
        t.update(tensor_core_bound(nbytes, ssd.bwd_flops(b, s, h, p, n, chunk),
                                 torch.float32))
        extra = (f", the earlier kernel's entry point {t['before_ms']!r} ms"
                 if "before_ms" in t else "")
        print(f"  ssd_bwd {label}: {t['ms']!r} ms through the wrapper, "
              f"entry point {t['entry_ms']!r} ms, in a CUDA graph "
              f"{t['graph_ms']!r} ms{extra}, bound "
              f"{t['bound_ms']!r} ms ({t['bound_by']}, 3xTF32; float32 "
              f"CUDA cores {t['bound_f32_cores_ms']!r} ms); autograd "
              f"through ref.ssd {t['plain_ms']!r} ms, ref.ssd_bwd "
              f"{t['closed_form_ms']!r} ms", flush=True)
        out["cases"][label] = t
    for line in ptxas_lines("ssd_bwd", "ssd_bwd"):
        print(f"  ssd_bwd (ptxas): {line}")
    out["sass"] = sass_counts("ssd_bwd")
    for fn, c in out["sass"].items():
        print(f"  ssd_bwd (SASS) {fn}: {c}")
    for stage in ("ssd_bwd_states_kernel", "ssd_bwd_grads_kernel"):
        if not any(stage in fn and c["hmma_tf32"] > 0
                   for fn, c in out["sass"].items()):
            raise AssertionError(f"{stage} holds no TF32 HMMA")
    if any(c["f32_atomics"] for c in out["sass"].values()):
        raise AssertionError("the SSD gradient library holds F32 atomics")
    return out


def time_router_case(logits: torch.Tensor, k: int, label: str,
                     floor: dict) -> dict:
    """moe_router_tk at a model's shape: its first rows tied (row 0 all
    equal, row 1 two equal maxima at experts 3 and E - 2), the indices
    equal to the plain version's exactly and the weights within
    TOL_TIGHT, then timed through the wrapper and at the C entry point,
    in turns, in a CUDA graph, and the plain version, beside the bound
    (the logits read once, weights and indices written once;
    ``rooflines.moe_router``'s flops) and the launch floor."""
    from repro_torch.kernels import _build, moe_router, ref
    from repro_torch.udfs import rooflines
    t, e = logits.shape
    logits[0] = 0.5
    logits[1, [3, e - 2]] = float(logits[1].max()) + 1.0
    err = check_router(logits, k, label)
    idx = moe_router.moe_router_tk(logits, k)[1][:2, :2].tolist()
    if idx != [[0, 1], [3, e - 2]]:
        raise AssertionError(f"moe_router {label}: tied rows routed to {idx}")
    w_out = torch.empty((t, k), device=logits.device)
    i_out = torch.empty((t, k), dtype=torch.int32, device=logits.device)
    args = moe_router.ARGS.pack(logits.data_ptr(), w_out.data_ptr(),
                                i_out.data_ptr(), t, e, k, 0)
    call = _build.load("moe_router").lib.moe_router_tk
    stream = torch.cuda.current_stream().cuda_stream
    if call(args, stream) != 0:
        raise AssertionError("moe_router entry point failed")
    out = {
        **paired_ms({"ms": lambda: moe_router.moe_router_tk(logits, k),
                     "entry_ms": lambda: call(args, stream)}),
        "graph_ms": graph_ms(lambda st: call(args, st)),
        "plain_ms": time_ms(lambda: ref.moe_topk_router(logits, k),
                            TIME_ITERS),
        **dict(zip(("bound_ms", "bound_by"), bound_ms(
            t * e * 4 + t * k * 8,
            t * rooflines.moe_router(e, k).flops_per_row))),
        "library_ms": None,   # no single PyTorch call routes top-k
        "max_abs_err": err,
    }
    print(f"  moe_router {label}: kernel {out['ms']!r} ms through the "
          f"wrapper (entry point {out['entry_ms']!r}, in a graph "
          f"{out['graph_ms']!r}), plain {out['plain_ms']!r} ms, bound "
          f"{out['bound_ms']!r} ms ({out['bound_by']}); launch floor "
          f"{floor['entry_ms']!r} / {floor['graph_ms']!r} ms", flush=True)
    return out


ROUTER_BWD_CASES = ((1024, 8, 2), (1024, 128, 2))   # grok's, arctic's (T, E, k)


def router_bwd_cases(floor: dict) -> dict:
    """Phase 3 for the router's gradient kernel (``moe_router_bwd``) at
    grok-1's and arctic-480b's (T, E, k), a third of the rows tied (their
    logits drawn from four values): the weights and experts from the
    forward kernel, a cotangent from a numpy seed; the kernel within
    TOL_TIGHT of ``ref.moe_router_bwd`` (the same products and order: it
    is bit-equal in practice), exactly 0 at every expert a row did not
    choose, the same bits on a rerun; timed through its wrapper, at its C
    entry point and in a CUDA graph, and the plain version, beside its
    bound (T E 4 bytes written, T k 12 read) and the launch floor."""
    from repro_torch.kernels import _build, moe_router, ref
    rng = np.random.default_rng(31)
    out = {}
    for t, e, k in ROUTER_BWD_CASES:
        label = f"T={t} E={e} k={k}"
        logits = rng.standard_normal((t, e)).astype(np.float32) * 1.6
        rows = rng.random(t) < 1 / 3
        logits[rows] = rng.choice(np.float32([-1.0, 0.25, 0.5, 2.0]),
                                  (int(rows.sum()), e))
        w, idx = moe_router.moe_router_tk(torch.from_numpy(logits).cuda(), k)
        dw = torch.from_numpy(rng.standard_normal((t, k)).astype(
            np.float32)).cuda()
        got = moe_router.moe_router_bwd(w, idx, dw, e)
        again = moe_router.moe_router_bwd(w, idx, dw, e)
        want = ref.moe_router_bwd(w, idx, dw, e)
        torch.cuda.synchronize()
        err, ok = within(got, want, **TOL_TIGHT)
        chosen = torch.zeros((t, e), dtype=torch.bool, device="cuda")
        chosen.scatter_(1, idx.long(), True)
        zeros = bool((got[~chosen] == 0).all())
        same = torch.equal(got, again)
        bits = torch.equal(got, want)
        print(f"  moe_router_bwd {label}, {int(rows.sum())} tied rows: "
              f"max_abs_err {err!r} (bit-equal {bits}), 0 at the experts "
              f"not chosen {zeros}, the same bits on a rerun {same}",
              flush=True)
        if not (ok and zeros and same):
            raise AssertionError(f"moe_router_bwd disagrees on {label}")
        res = torch.empty((t, e), device="cuda")
        args = moe_router.BWD_ARGS.pack(w.data_ptr(), idx.data_ptr(),
                                        dw.data_ptr(), res.data_ptr(),
                                        t, e, k, 0)
        call = _build.load("moe_router").lib.moe_router_bwd
        stream = torch.cuda.current_stream().cuda_stream
        if call(args, stream) != 0:
            raise AssertionError("moe_router_bwd entry point failed")
        timing = {
            **paired_ms({"ms": lambda: moe_router.moe_router_bwd(w, idx, dw,
                                                                  e),
                         "entry_ms": lambda: call(args, stream)}),
            "graph_ms": graph_ms(lambda st: call(args, st)),
            "plain_ms": time_ms(lambda: ref.moe_router_bwd(w, idx, dw, e),
                                TIME_ITERS),
            **dict(zip(("bound_ms", "bound_by"), bound_ms(
                t * e * 4 + t * k * 12, moe_router.bwd_flops(t, k)))),
            "library_ms": None,   # no single PyTorch call is this gradient
            "max_abs_err": err, "bit_equal": bits,
            # what every model-path wrapper now adds before a launch: the
            # check that its inputs are not fake (``_build.traced``)
            "fake_check_ms": time_ms(lambda: _build.traced(
                "moe_router_bwd", 0, (w, idx, dw), (res,)), TIME_ITERS)}
        print(f"  moe_router_bwd {label}: kernel {timing['ms']!r} ms through "
              f"the wrapper (entry point {timing['entry_ms']!r}, in a graph "
              f"{timing['graph_ms']!r}), plain {timing['plain_ms']!r} ms, "
              f"bound {timing['bound_ms']!r} ms ({timing['bound_by']}); "
              f"launch floor {floor['entry_ms']!r} / {floor['graph_ms']!r} ms;"
              f" the wrappers' fake-tensor check {timing['fake_check_ms']!r} "
              "ms a call", flush=True)
        out[label] = timing
    return out


# ref.flash_bf16_limit's own check: copies of csrc/flash_attention.cu,
# each broken in one place of its shared kernel (what it breaks, the
# lines, their replacement), which the limit must refuse at grok-1-314b's
# bf16 attention (kv group 6, three heads a CTA)
FLASH_MUTANTS = (
    ("drops the last query block's last key tile",
     "  if (!o.valid) o.nt = 0;\n  return o;\n",
     "  if (!o.valid) o.nt = 0;\n"
     "  o.nt -= o.q0 + kRows >= p.sq && o.nt > 1;\n  return o;\n"),
    ("scales every later query block's last key tile's P.V by 1 + 2^-5",
     "        to_frags<BN>(pa, s);\n      }\n      probe.lap(kPvWait);\n",
     "        if (i > mine_lo && i == mine_hi - 1)\n"
     "          for (int e = 0; e < BN / 2; ++e) s[e] *= 1.03125f;\n"
     "        to_frags<BN>(pa, s);\n      }\n      probe.lap(kPvWait);\n"),
    ("feeds every warpgroup of a CTA its first warpgroup's Q",
     "    const Slot x = slot_at<W, BN>(w, un, s);\n    const Src q[1] = {\n",
     "    const Slot x = slot_at<W, BN>(w, un, 0);\n    const Src q[1] = {\n"),
)


def build_flash_mutants() -> list:
    """The entry points of FLASH_MUTANTS, built side by side in a
    temporary directory (removed once they are loaded)."""
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(len(FLASH_MUTANTS)) as pool:
        return list(pool.map(
            lambda i: build_variant(
                "flash_attention", *FLASH_MUTANTS[i][1:],
                os.path.join(tmp, f"flash_mutant{i}.cu"),
                "flash_attention_bshd"), range(len(FLASH_MUTANTS))))


def flash_sass() -> dict:
    """The flash library's instances from ``cuobjdump -sass``
    (``sass_counts``): every bf16 instance (flash_wgmma_kernel,
    flash_shared_kernel) must hold HGMMA and no instance an F32 atomic;
    and from ptxas, each shared instance's registers and no spills.
    Returns {instance: counts}."""
    out = {}
    for fn, c in sass_counts("flash_attention").items():
        bf16 = "flash_wgmma_kernel" in fn or "flash_shared_kernel" in fn
        if not bf16 and "flash_kernel" not in fn:
            continue
        out[fn] = c
        print(f"  flash_attention SASS {fn}: {c['hgmma']} HGMMA, "
              f"{c['hmma_tf32']} TF32 HMMA, {c['f32_atomics']} F32 atomics",
              flush=True)
        if (bf16 and c["hgmma"] == 0) or c["f32_atomics"]:
            raise AssertionError(f"flash_attention {fn}: {c}")
    lines = ptxas_lines("flash_attention", "flash_shared_kernel")
    for line in lines:
        print(f"  flash shared instances (ptxas): {line}", flush=True)
    spills = [int(n) for line in lines
              for n in re.findall(r"(\d+) bytes spill", line)]
    if not spills or any(spills):
        raise AssertionError(f"flash shared instances spill: {lines}")
    out["shared_ptxas"] = lines
    return out


def build_flash_probe():
    """``csrc/flash_attention.cu`` built with ``-DFLASH_PROBE`` (the tick
    probe, which the shipped library compiles out) in a temporary
    directory, removed once it is loaded: the library, with its
    ``flash_attention_variant`` and ``flash_probe_take``."""
    from repro_torch.kernels import _build
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flash_probe.so")
        proc = subprocess.run(
            [_build.nvcc_path(), *_build.flags("flash_attention"),
             "-DFLASH_PROBE", "-o", path,
             str(_build.CSRC / "flash_attention.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the flash probe:\n"
                               f"{proc.stdout}{proc.stderr}")
        lib = ctypes.CDLL(path)
    fn = lib.flash_attention_variant
    fn.argtypes, fn.restype = _build.SIGNATURES["flash_attention"][
        "flash_attention_variant"]
    lib.flash_probe_take.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.flash_probe_take.restype = ctypes.c_int
    return lib


# the tick probe's shapes, (B, Sq, Sk, H, Hkv, D, causal): the LLM
# predicate's 64 rows and whisper-small's encoder; its stretches, in the
# order of the kernels' Lap
PROBE_SHAPES = (("LLM predicate", (64, 512, 512, 9, 3, 64, True)),
                ("whisper-small encoder", (4, 1500, 1500, 12, 12, 64, False)))
PROBE_LAPS = ("setup", "q_wait", "stage_wait", "s_wait", "softmax",
              "pv_wait", "epilogue")
PROBE_CTAS = 16384   # the probe's kProbeCtas


def flash_probe(lib) -> dict:
    """Where a CTA's chain spends its clock64 ticks, from the probe library
    (``build_flash_probe``): at each of PROBE_SHAPES, one launch of the
    design of a CTA a query tile and of the shared design, each CTA's
    thread 0 adding the ticks of each stretch (setup; waiting for Q; for a
    tile's K/V stage; for S; the softmax; waiting for P.V, with the
    rescale; the epilogue) over its units. Prints each design's CTAs,
    their mean ticks and each stretch's share of the sum."""
    from repro_torch.kernels import flash_attention
    rng = np.random.default_rng(29)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, (b, sq, sk, h, hkv, d, causal) in PROBE_SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d)).astype(
            np.float32)).cuda().to(torch.bfloat16)
            for s, n in ((sq, h), (sk, hkv), (sk, hkv)))
        o = torch.empty_like(q)
        args = flash_attention.pack_args(
            q, k, v, o, tuple(map(flash_attention.bshd_layout, (q, k, v, o))),
            batch=b, heads=h, group=h // hkv, sq=sq, sk=sk, causal=causal,
            window=0, scale=d ** -0.5)
        ctas = min(PROBE_CTAS, b * h * -(-sq // 64))
        ticks = np.zeros((ctas, len(PROBE_LAPS) + 1), np.int64)
        for variant, design in flash_attention.VARIANTS.items():
            for _ in range(2):   # the second launch is read
                lib.flash_probe_take(ticks.ctypes.data, ctas)
                if lib.flash_attention_variant(args, variant, stream) != 0:
                    raise AssertionError(f"the flash probe failed at {name}")
                torch.cuda.synchronize()
            if lib.flash_probe_take(ticks.ctypes.data, ctas) != 0:
                raise AssertionError("flash_probe_take failed")
            live = ticks[ticks[:, -1] > 0]
            total = int(live[:, -1].sum())
            split = {lap: float(live[:, i].sum() / total)
                     for i, lap in enumerate(PROBE_LAPS)}
            res = {"ctas": int(len(live)),
                   "mean_ticks_a_cta": float(live[:, -1].mean()),
                   "longest_cta_ticks": int(live[:, -1].max()),
                   "split": split}
            out[f"{name} {design}"] = res
            print(f"  flash probe at {name} B={b} Sq={sq} H={h} Hkv={hkv} "
                  f"D={d}, {design}: {res['ctas']} CTAs, "
                  f"{res['mean_ticks_a_cta']!r} ticks a CTA (longest "
                  f"{res['longest_cta_ticks']}), split "
                  + ", ".join(f"{lap} {x:.3f}" for lap, x in split.items()),
                  flush=True)
    return out


def flash_limit_mutants(mutants: list) -> dict:
    """At grok-1-314b's bf16 attention (inputs from a numpy seed), the
    kernel through its wrapper and each of FLASH_MUTANTS at its entry
    point against the plain version: the kernel within
    ``flash_bf16_limit``, every mutant past it (within TOL_BF16 or not,
    as it happens)."""
    from repro_torch.kernels import flash_attention, ref
    rng = np.random.default_rng(23)
    b, s, h, hkv, d = 2, 512, 48, 8, 128
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d)).astype(
        np.float32)).cuda().to(torch.bfloat16) for n in (h, hkv, hkv))
    want = ref.flash_attention_bshd(q, k, v)
    limit = ref.flash_bf16_limit(q, k, v, want)
    stream = torch.cuda.current_stream().cuda_stream
    outs = {"sound kernel": flash_attention.flash_attention_bshd(q, k, v)}
    for (what, _, _), call in zip(FLASH_MUTANTS, mutants):
        got = outs[what] = torch.empty_like(q)
        args = flash_attention.pack_args(
            q, k, v, got, tuple(map(flash_attention.bshd_layout,
                                    (q, k, v, got))),
            batch=b, heads=h, group=h // hkv, sq=s, sk=s, causal=True,
            window=0, scale=d ** -0.5)
        if call(args, stream) != 0:
            raise AssertionError(f"the flash mutant that {what} failed")
    torch.cuda.synchronize()
    res = {}
    for what, got in outs.items():
        err, share = limit_share(got, want, limit)
        res[what] = {"max_abs_err": err, "largest_share_of_limit": share,
                     "within_tol_bf16": within(got, want, **TOL_BF16)[1]}
        print(f"  flash_bf16_limit at grok-1-314b B={b} S={s} H={h} "
              f"Hkv={hkv} D={d} bf16, {what}: max_abs_err {err!r}, largest "
              f"share of the limit {share!r}, within TOL_BF16: "
              f"{res[what]['within_tol_bf16']}", flush=True)
        if (what == "sound kernel") != (share <= 1.0):
            raise AssertionError(f"flash_bf16_limit misjudges the {what}")
    return res


def family_kernel_cases(floor: dict, ssd_mutants=(), before=None) -> dict:
    """Phase 3 at the shapes the model families give the kernels (inputs
    from a numpy seed): ssd at mamba2-370m's scan (with its mutants and
    beside ``before``'s, see ``time_ssd_case``), rglru at
    recurrentgemma-9b's forward and decode step, flash at its local
    attention, at whisper-small's encoder and cross-attention and at
    grok-1-314b's and arctic-480b's attention, and the router at the moe
    forwards' (T, E, k), each against its plain version, timed (flash
    beside SDPA) and bounded. Returns {kernel: {label: timings}}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bshd
    rng = np.random.default_rng(21)

    def T(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda(
        ).to(dtype)

    out = {"ssd": {}, "rglru": {}, "flash_attention": {}, "moe_router": {}}
    # mamba2-370m: x, B, C as silu outputs, dt softplus(~0) of the scan
    b, s, h, p, g, n = 4, 512, 32, 64, 1, 128
    label = f"mamba2-370m B={b} S={s} H={h} P={p} G={g} N={n}"
    out["ssd"][label] = time_ssd_case(
        T(rng.standard_normal((b, s, h, p)) * 0.5),
        T(rng.uniform(0.5, 1.0, (b, s, h))), T(-np.exp(np.full(h, 0.1))),
        T(rng.standard_normal((b, s, g, n)) * 0.3),
        T(rng.standard_normal((b, s, g, n)) * 0.3), label, ssd_mutants,
        before)
    # recurrentgemma-9b: the forward's (1, 2560, 4096), no h0; the train
    # step's (2, 2560, 4096), the h sequence kept for the gradient, with
    # and without an h0; a decode step's (1, 1, 4096) from a bf16 state
    w = 4096
    terms = rglru_term_instructions()
    print(f"  rglru pipelined terms in the SASS: {terms}", flush=True)
    for (b, s), with_h0, keep_hs, what in (
            ((1, 2560), False, False, "forward"),
            ((2, 2560), False, True, "train"),
            ((2, 2560), True, True, "train"),
            ((1, 1), True, False, "decode step")):
        label = (f"recurrentgemma-9b {what} B={b} S={s} W={w} h0 "
                 f"{'given' if with_h0 else 'None'}")
        out["rglru"][label] = time_rglru_case(
            *(T(rng.standard_normal((b, s, w))) for _ in range(3)),
            T(rng.standard_normal(w)),
            T(rng.standard_normal((b, w))) if with_h0 else None, label,
            keep_hs, terms, before)
        out["rglru"][label]["sass_terms"] = terms
    # flash: (B, Sq, Sk, H, Hkv, D, causal, window, dtype), the models' own
    # views; bf16 held to flash_bf16_limit, float32 (3xTF32) to TOL_TIGHT
    bf16, f32 = torch.bfloat16, torch.float32
    for name, (b, sq, sk, h, hkv, d, causal, window, dt) in (
            ("recurrentgemma-9b local attention",
             (1, 2560, 2560, 16, 1, 256, True, 2048, bf16)),
            ("whisper-small encoder",
             (4, 1500, 1500, 12, 12, 64, False, 0, bf16)),
            ("whisper-small cross-attention",
             (4, 64, 1500, 12, 12, 64, False, 0, bf16)),
            ("grok-1-314b attention", (2, 512, 512, 48, 8, 128, True, 0, bf16)),
            ("grok-1-314b attention", (2, 512, 512, 48, 8, 128, True, 0, f32)),
            ("arctic-480b attention",
             (2, 512, 512, 56, 8, 128, True, 0, bf16))):
        q = T(rng.standard_normal((b, sq, h, d)), dt)
        k, v = (T(rng.standard_normal((b, sk, hkv, d)), dt)
                for _ in range(2))
        label = (f"{name} B={b} Sq={sq} Sk={sk} H={h} Hkv={hkv} D={d} "
                 f"causal={causal} window={window} "
                 f"{'bf16' if dt == bf16 else 'f32'}")
        kw = {"causal": causal, "window": window}
        got = flash_attention_bshd(q, k, v, **kw)
        want = ref.flash_attention_bshd(q, k, v, **kw)
        tol = (ref.flash_bf16_limit(q, k, v, want, **kw) if dt == bf16
               else TOL_TIGHT)
        err = check_close("flash_attention", got, want, label, tol=tol)
        share = {"largest_share_of_limit": limit_share(got, want, tol)[1]
                 } if dt == bf16 else {}
        out["flash_attention"][label] = {
            **time_flash(q, k, v, group=h // hkv, causal=causal,
                         window=window, label=label,
                         before=before and before["flash_attention"]),
            "max_abs_err": err, **share}
    for kernel in ("flash_wgmma_kernelILi256E", "flash_shared_kernelILi256E"):
        for line in ptxas_lines("flash_attention", kernel):
            print(f"  flash bf16 D=256 instances (ptxas): {line}")
    # the router at a moe forward's tokens (B * S = 1024): grok-1's 8
    # experts (a thread a row) and arctic's 128 (a warp a row); logits
    # spread as a bf16 layer's router gives them (std 1.6)
    for e in (8, 128):
        label = f"T=1024 E={e} k=2"
        out["moe_router"][label] = time_router_case(
            T(rng.standard_normal((1024, e)) * 1.6), 2, label, floor)
    for line in ptxas_lines("moe_router", "warp"):
        print(f"  moe_router warp-a-row instance (ptxas): {line}")
    return out


# (arch, forward (B, S), prompt (B, S), decode steps, launches a forward,
# launches a decode step, the dtype its logits are held in) at each
# config's full width and depth. mamba2-370m's and recurrentgemma-9b's
# are held in float32: in bf16 their random-weight layers carry single
# rounding flips past TOL_BF16 in the logits whatever the kernel (the
# plain kernels against themselves with every output changed by 3e-6
# before its cast differ as much: PERF.md, PR 18); the bf16 run's
# differences are printed beside that control.
FAMILIES = (
    ("mamba2-370m", (4, 512), (4, 60), 4, {"ssd": 48}, {}, "float32"),
    ("recurrentgemma-9b", (1, 2560), (1, 2560), 2,
     {"rglru": 26, "flash_attention": 12}, {"rglru": 26}, "float32"),
    ("whisper-small", (4, 64), (4, 64), 2, {"flash_attention": 36},
     {"flash_attention": 12}, "bfloat16"),
)
FAMILY_SEED = 0
FAMILY_ROUNDS = 5     # timed forwards and decode steps, of which the median
COUNTED = ("ssd", "rglru", "flash_attention", "moe_router")  # the model
                                                            # kernels' counters
CONTROL_NOISE = 3e-6  # relative change of the control's ssd output


def kernel_launches() -> dict:
    """Each model kernel's launch counter that moved: {name: count}."""
    import importlib
    counts = {name: importlib.import_module(
        f"repro_torch.kernels.{name}").launches for name in COUNTED}
    return {k: v for k, v in counts.items() if v}


def zero_launches() -> None:
    import importlib
    for name in COUNTED:
        importlib.import_module(f"repro_torch.kernels.{name}").launches = 0


def family_ms(fn, rounds: int = FAMILY_ROUNDS) -> dict:
    """One call's milliseconds, the median of ``rounds`` after one
    warm-up: between CUDA events on the stream and on the host clock to
    the end of a synchronize."""
    fn()
    torch.cuda.synchronize()
    events, host = [], []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    return {"event_ms": float(np.median(events)),
            "host_ms": float(np.median(host)), "event_ms_rounds": events}


@contextlib.contextmanager
def perturbed_plain():
    """Inside the block the models run the kernels' plain versions in
    float32 with every output changed by a relative CONTROL_NOISE (seeded)
    before its cast to the model's dtype (the router's plain version as it
    is: its outputs are float32 and its indices exact): a stand-in for
    kernels that sum in another order, the control beside a bf16
    forward's difference."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention, hybrid, moe, ssm
    gens = {}

    def noisy(t: torch.Tensor, dtype) -> torch.Tensor:
        if t.device not in gens:
            gens[t.device] = torch.Generator(t.device).manual_seed(1)
        noise = torch.randn(t.shape, generator=gens[t.device], device=t.device)
        return (t * (1 + CONTROL_NOISE * noise)).to(dtype)

    def flash(q, k, v, **kw):
        f32 = torch.float32
        return noisy(ref.flash_attention_bshd(q.to(f32), k.to(f32),
                                              v.to(f32), **kw), q.dtype)

    def scan(plain):
        def run(x, *args, **kw):
            y, h_last = plain(x.to(torch.float32), *args, **kw)
            return noisy(y, x.dtype), h_last.to(
                torch.float32 if plain is ref.ssd else x.dtype)
        return run

    swaps = ((attention, "flash_attention_bshd", flash),
             (ssm, "ssd_bshp", scan(ref.ssd)),
             (hybrid, "rglru_bsw", scan(ref.rglru)),
             (moe, "moe_router_tk", ref.moe_topk_router))
    kernels = [(module, name, getattr(module, name))
               for module, name, _ in swaps]
    for module, name, fn in swaps:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, kernel in kernels:
            setattr(module, name, kernel)


class FamilyRun:
    """One family's model at its config's full width and depth in one
    dtype, weights from ``torch.Generator("cuda").manual_seed(FAMILY_SEED)``
    (the float32 and bf16 models hold the same draws, rounded once for
    bf16), with its token ids and frames from a numpy seed. ``changes``
    replace config fields (a moe model's cut depth)."""

    def __init__(self, arch: str, dtype: str, rows: int, seq: int,
                 device="cuda", **changes):
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.models.registry import model_api
        self.cfg = dataclasses.replace(get_config(arch), dtype=dtype,
                                       **changes)
        self.api = model_api(self.cfg)
        dev = torch.device(device)
        t0 = time.perf_counter()
        self.model = self.api.init_params(
            self.cfg, torch.Generator(dev).manual_seed(FAMILY_SEED),
            device=dev)
        torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0
        rng = np.random.default_rng(FAMILY_SEED)
        self.toks = torch.from_numpy(rng.integers(
            0, self.cfg.vocab_size, (rows, seq)).astype(np.int32)).to(dev)
        self.frames = None
        if self.cfg.family == "encdec":
            self.frames = torch.from_numpy(rng.standard_normal(
                (rows, self.cfg.num_frames, self.cfg.d_model)).astype(
                    np.float32)).to(dev)

    def batch(self, b: int, s: int) -> dict:
        out = {"tokens": self.toks[:b, :s]}
        if self.frames is not None:
            out["frames"] = self.frames[:b]
        return out

    def forward(self, batch):
        return self.api.forward(self.cfg, self.model, batch)

    def check_forward(self, fwd: tuple, want: dict, gate: bool) -> dict:
        """One forward through the kernels, its launches counted from 0,
        against the same forward through their plain versions; with
        ``gate``, the logits within TOL_BF16 or the phase fails."""
        cfg = self.cfg
        x = self.batch(*fwd)
        with torch.inference_mode():
            zero_launches()
            logits = self.forward(x)
            torch.cuda.synchronize()
            counts = kernel_launches()
            with plain_kernels():
                plain = self.forward(x)
            err, ok = within(logits, plain, **TOL_BF16)
            live = plain[..., :cfg.vocab_size].float().abs()
            out = {"shape": list(fwd), "dtype": cfg.dtype, "launches": counts,
                   "max_abs_err": err, "within_tol_bf16": ok,
                   "abs_logit_range": [float(live.min()), float(live.max())]}
            finite = bool(torch.isfinite(logits).all())
            del logits, live
            if cfg.dtype == "bfloat16":
                with perturbed_plain():
                    control = self.forward(x)
                out["control_max_abs_err"] = within(control, plain,
                                                    **TOL_BF16)[0]
                del control
        control = (f"; control, the plain kernels against themselves with "
                   f"each output changed by {CONTROL_NOISE!r} before its "
                   f"cast: {out['control_max_abs_err']!r}"
                   if "control_max_abs_err" in out else "")
        print(f"  forward {tuple(fwd)} {cfg.dtype}: max_abs_err against the "
              f"plain kernels {err!r} (|logit| {out['abs_logit_range'][0]!r}"
              f"..{out['abs_logit_range'][1]!r}; within TOL_BF16: {ok}"
              f"{'' if gate else ', not gated'}){control}; finite {finite}; "
              f"launches {counts} (want {want})", flush=True)
        if counts != want:
            raise AssertionError(f"{cfg.name}: a forward launched {counts}, "
                                 f"not {want}")
        if not finite or (gate and not ok):
            raise AssertionError(f"{cfg.name} {cfg.dtype}: the forward "
                                 "through the kernels disagrees with their "
                                 "plain versions")
        return out

    def check_decode(self, prompt: tuple, steps: int, want: dict,
                     gate: bool) -> dict:
        """A prefill of the prompt and ``steps`` decode steps (each step's
        launches counted from 0) against full forwards over the same
        tokens; with ``gate``, every step's logits within TOL_BF16."""
        cfg, api = self.cfg, self.api
        b, s = prompt
        kw = {"pad_cache_to": s + steps} if cfg.family == "encdec" else {}
        errs, oks, counts = [], [], []
        with torch.inference_mode():
            cache, last = api.prefill(cfg, self.model, self.batch(b, s), **kw)
            for step in range(steps + 1):
                if step:
                    zero_launches()
                    cache, last = api.decode_step(
                        cfg, self.model, cache,
                        {"token": self.toks[:b, s + step - 1]})
                    torch.cuda.synchronize()
                    counts.append(kernel_launches())
                full = self.forward(self.batch(b, s + step))[:, -1]
                err, ok = within(last, full, **TOL_BF16)
                errs.append(err)
                oks.append(ok and bool(torch.isfinite(last).all()))
        lengths = cache["lengths"].tolist()
        print(f"  prefill {(b, s)} and {steps} decode steps {cfg.dtype}: "
              f"max_abs_err against the full forward per step {errs!r} "
              f"(within TOL_BF16: {oks}{'' if gate else ', not gated'}); "
              f"launches a step {counts} (want {want}); lengths {lengths}",
              flush=True)
        if lengths != [s + steps] * b:
            raise AssertionError(f"{cfg.name}: decode left the lengths at "
                                 f"{lengths}")
        if any(c != want for c in counts):
            raise AssertionError(f"{cfg.name}: decode steps launched "
                                 f"{counts}, not {want} each")
        if gate and not all(oks):
            raise AssertionError(f"{cfg.name} {cfg.dtype}: decode logits "
                                 "disagree with the full forward")
        return {"prompt": [b, s], "steps": steps, "dtype": cfg.dtype,
                "max_abs_err_by_step": errs, "within_tol_bf16": oks,
                "launches_a_step": want, "cache": cache,
                "token": {"token": self.toks[:b, s + steps - 1]}}

    def times(self, fwd: tuple, decode: dict) -> dict:
        """A forward's and a decode step's times (``family_ms``) and a
        ``torch.profiler`` split of one forward, with its busy share."""
        cfg, api, model = self.cfg, self.api, self.model
        x = self.batch(*fwd)
        cache, token = decode.pop("cache"), decode.pop("token")
        with torch.inference_mode():
            fwd_ms = family_ms(lambda: self.forward(x))
            step_ms = family_ms(
                lambda: api.decode_step(cfg, model, cache, token))
            trace = device_trace(self.forward, x)
        busy = trace["device_ms"] / fwd_ms["host_ms"]
        print(f"  forward {fwd_ms['event_ms']!r} ms between CUDA events "
              f"({fwd_ms['host_ms']!r} on the host clock); decode step "
              f"{step_ms['event_ms']!r} ms ({step_ms['host_ms']!r}); one "
              f"traced forward: {trace['device_ms']!r} ms of device time "
              f"over {trace['kernels']} kernels (busy share {busy!r}), split "
              f"{trace['split_ms']}, launches {trace['split_launches']}",
              flush=True)
        return {"forward_ms": fwd_ms, "decode_step_ms": step_ms,
                "trace": trace, "busy_share": busy}


def run_family(arch: str, fwd: tuple, prompt: tuple, steps: int,
               want_fwd: dict, want_step: dict, check_dtype: str,
               device="cuda") -> dict:
    """One model family in bf16 at its config's full width and depth: a
    forward through the kernels against their plain versions, a prefill
    and decode steps against full forwards, then times. The logits are
    held to TOL_BF16 in ``check_dtype``: in bf16 on this run, or, for
    float32, on a second run of the same model in float32 (the bf16
    run's differences are printed beside a control)."""
    rows = max(fwd[0], prompt[0])
    seq = max(fwd[1], prompt[1] + steps)
    torch.cuda.reset_peak_memory_stats()
    run = FamilyRun(arch, "bfloat16", rows, seq, device)
    cfg = run.cfg
    print(f"  {arch} ({cfg.family}): {cfg.num_layers} layers"
          f"{f' + {cfg.num_encoder_layers} encoder' if cfg.num_encoder_layers else ''}"
          f", d_model {cfg.d_model}, vocab {cfg.vocab_size} (padded "
          f"{cfg.vocab_padded}); {run.api.param_count(cfg)} parameters drawn "
          f"on the card in {run.init_s:.2f}s", flush=True)
    gate = check_dtype == "bfloat16"
    res = {"arch": arch, "family": cfg.family,
           "params": run.api.param_count(cfg), "init_s": run.init_s,
           "checked_in": check_dtype,
           "forward": run.check_forward(fwd, want_fwd, gate)}
    res["decode"] = run.check_decode(prompt, steps, want_step, gate)
    res.update(run.times(fwd, res["decode"]))
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del run
    torch.cuda.empty_cache()
    if not gate:
        run = FamilyRun(arch, check_dtype, rows, seq, device)
        res[f"forward_{check_dtype}"] = run.check_forward(fwd, want_fwd, True)
        decode = run.check_decode(prompt, steps, want_step, True)
        del decode["cache"], decode["token"], run
        res[f"decode_{check_dtype}"] = decode
        torch.cuda.empty_cache()
    return res


def run_families() -> dict:
    """Phase 10: every family of FAMILIES, one at a time."""
    out = {}
    for arch, *spec in FAMILIES:
        t0 = time.perf_counter()
        out[arch] = run_family(arch, *spec)
        out[arch]["phase_s"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------- #
# phase 11: the moe family                                                    #
# --------------------------------------------------------------------------- #
# (arch, layers in bf16, layers of the float32 gate, forward (B, S), prompt
# (B, S), decode steps) at each config's full width, its depth cut to what
# one H100's 80 GB holds: grok-1-314b's layers take 9.84 GB each in bf16
# beside 3.22 GB of embedding and head (6 of 64: 62.3 GB), arctic-480b's
# 27.2 GB (2 of 35: 55.4 GB). A bf16 ulp in the attention moves tokens
# across a top-2 boundary and the flipped tokens' logits then differ far
# past TOL_BF16 (PERF.md, PR 19), so the logits are gated in float32 on a
# shallower cut of the same draws (grok 2 layers, 45.8 GB; arctic 1,
# 56.3 GB) and the bf16 run prints its differences beside the control,
# the share of routing assignments that agree and the drops.
MOE = (
    ("grok-1-314b", 6, 2, (2, 512), (2, 64), 4),
    ("arctic-480b", 2, 1, (2, 512), (2, 64), 2),
)


@contextlib.contextmanager
def recorded_routes():
    """Inside the block every ``models.moe.dispatch`` call appends its
    (idx (T, k), tok (E, C)) to the list the block gets."""
    from repro_torch.models import moe
    routes, dispatch = [], moe.dispatch

    def recorded(idx, weights, num_experts, capacity):
        tok, w = dispatch(idx, weights, num_experts, capacity)
        routes.append((idx, tok))
        return tok, w

    moe.dispatch = recorded
    try:
        yield routes
    finally:
        moe.dispatch = dispatch


def route_stats(kernel: list, plain: list) -> dict:
    """Each layer's routing through the kernels against the plain run's:
    the share of (token, slot) assignments with the same expert, and the
    assignments each run dropped by capacity."""
    same, drops, drops_plain = [], [], []
    for (idx, tok), (idx_p, tok_p) in zip(kernel, plain, strict=True):
        t = idx.shape[0]
        same.append(float((idx == idx_p).float().mean()))
        drops.append(idx.numel() - int((tok < t).sum()))
        drops_plain.append(idx_p.numel() - int((tok_p < t).sum()))
    return {"assignments_agree": same, "dropped": drops,
            "dropped_plain": drops_plain}


class MoeRun(FamilyRun):
    """A moe model at its config's full width, cut to ``num_layers``; its
    forward gives the logits (the aux loss kept in ``aux``)."""

    def forward(self, batch):
        logits, self.aux = self.api.forward(self.cfg, self.model, batch)
        return logits

    def check_forward(self, fwd: tuple, want: dict, gate: bool) -> dict:
        """``FamilyRun.check_forward`` with each layer's routing through
        the kernels held against the plain run's (``route_stats``)."""
        layers = self.cfg.num_layers
        with recorded_routes() as routes:
            out = super().check_forward(fwd, want, gate)
            out["routing"] = route_stats(routes[:layers],
                                         routes[layers:2 * layers])
        print(f"  routing {self.cfg.dtype}: share of assignments on the "
              f"same expert by layer {out['routing']['assignments_agree']!r}"
              f"; dropped by capacity by layer {out['routing']['dropped']} "
              f"(plain {out['routing']['dropped_plain']}) of "
              f"{2 * fwd[0] * fwd[1]}; aux {float(self.aux)!r}", flush=True)
        return out

    def check_decode(self, prompt: tuple, steps: int, want_prefill: dict,
                     want: dict, gate: bool) -> dict:
        """A prefill of the prompt and ``steps`` decode steps through the
        kernels (the prefill's launches and each step's counted from 0,
        held to ``want_prefill`` and ``want``) against the same
        prefill and steps through their plain versions, on caches of
        their own; with ``gate``, every step's logits within TOL_BF16. Not
        against full forwards: a forward's capacity drops assignments that
        a step's does not, in the reference too."""
        cfg, api = self.cfg, self.api
        b, s = prompt
        batch, kw = self.batch(b, s), {"pad_cache_to": s + steps}
        errs, oks, counts, drops = [], [], [], []
        with torch.inference_mode():
            zero_launches()
            cache, last = api.prefill(cfg, self.model, batch, **kw)
            torch.cuda.synchronize()
            prefill_launches = kernel_launches()
            with plain_kernels():
                cache_p, last_p = api.prefill(cfg, self.model, batch, **kw)
            for step in range(steps + 1):
                if step:
                    token = {"token": self.toks[:b, s + step - 1]}
                    with recorded_routes() as routes:
                        zero_launches()
                        cache, last = api.decode_step(cfg, self.model, cache,
                                                      token)
                        torch.cuda.synchronize()
                        counts.append(kernel_launches())
                        with plain_kernels():
                            cache_p, last_p = api.decode_step(
                                cfg, self.model, cache_p, token)
                    drops.append(sum(idx.numel() - int((tok < b).sum())
                                     for idx, tok in routes[:cfg.num_layers]))
                err, ok = within(last, last_p, **TOL_BF16)
                errs.append(err)
                oks.append(ok and bool(torch.isfinite(last).all()))
        lengths = cache["lengths"].tolist()
        print(f"  prefill {(b, s)} (launches {prefill_launches}) and {steps} "
              f"decode steps {cfg.dtype}: max_abs_err against the same "
              f"through the plain kernels per step {errs!r} (within "
              f"TOL_BF16: {oks}{'' if gate else ', not gated'}); launches a "
              f"step {counts} (want {want}); dropped a step {drops}; lengths "
              f"{lengths}", flush=True)
        if lengths != [s + steps] * b:
            raise AssertionError(f"{cfg.name}: decode left the lengths at "
                                 f"{lengths}")
        if prefill_launches != want_prefill:
            raise AssertionError(f"{cfg.name}: the prefill launched "
                                 f"{prefill_launches}, not {want_prefill}")
        if any(c != want for c in counts):
            raise AssertionError(f"{cfg.name}: decode steps launched "
                                 f"{counts}, not {want} each")
        if gate and not all(oks):
            raise AssertionError(f"{cfg.name} {cfg.dtype}: decode logits "
                                 "disagree with the plain kernels'")
        return {"prompt": [b, s], "steps": steps, "dtype": cfg.dtype,
                "prefill_launches": prefill_launches,
                "max_abs_err_by_step": errs, "within_tol_bf16": oks,
                "dropped_by_step": drops, "launches_a_step": want,
                "cache": cache, "token": {"token": self.toks[:b, s + steps - 1]}}


def run_moe(arch: str, layers: int, gate_layers: int, fwd: tuple,
            prompt: tuple, steps: int, device="cuda") -> dict:
    """One moe config at full width cut to ``layers`` in bf16: a forward
    through the kernels against their plain versions (not gated: routing
    flips), a prefill and decode steps against the same through the plain
    versions, times; then the same checks gated at TOL_BF16 on the model
    cut to ``gate_layers`` in float32."""
    from repro_torch.configs import get_config
    rows = max(fwd[0], prompt[0])
    seq = max(fwd[1], prompt[1] + steps)
    full = get_config(arch)
    res = {"arch": arch, "family": full.family,
           "reduced": {"num_layers": [full.num_layers, layers],
                       "float32_gate_num_layers": [full.num_layers,
                                                   gate_layers],
                       "why": "one H100's 80 GB; widths as published"}}
    for dtype, depth in (("bfloat16", layers), ("float32", gate_layers)):
        torch.cuda.reset_peak_memory_stats()
        run = MoeRun(arch, dtype, rows, seq, device, num_layers=depth)
        cfg = run.cfg
        params = run.api.param_count(cfg)
        print(f"  {arch} ({cfg.family}) {dtype}: {depth} of "
              f"{full.num_layers} layers (reduced: one H100's 80 GB), d_model "
              f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
              f"{cfg.head_dim}, {cfg.num_experts} experts of d_ff {cfg.d_ff}"
              f", top-{cfg.num_experts_per_tok}, vocab {cfg.vocab_size}; "
              f"{params} parameters drawn on the card in {run.init_s:.2f}s",
              flush=True)
        want_fwd = {"flash_attention": depth, "moe_router": depth}
        want_step = {"moe_router": depth}
        gate = dtype == "float32"
        sfx = "" if dtype == "bfloat16" else f"_{dtype}"
        res[f"params{sfx}"], res[f"init_s{sfx}"] = params, run.init_s
        res[f"forward{sfx}"] = run.check_forward(fwd, want_fwd, gate)
        decode = run.check_decode(prompt, steps, want_fwd, want_step, gate)
        if gate:
            del decode["cache"], decode["token"]
        else:
            res.update(run.times(fwd, decode))
        res[f"decode{sfx}"] = decode
        res[f"peak_memory_gb{sfx}"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"  peak memory {res[f'peak_memory_gb{sfx}']!r} GB", flush=True)
        del run
        torch.cuda.empty_cache()
    res["checked_in"] = "float32"
    return res


def run_moe_family() -> dict:
    """Phase 11: every config of MOE, one at a time."""
    out = {}
    for arch, *spec in MOE:
        t0 = time.perf_counter()
        out[arch] = run_moe(arch, *spec)
        out[arch]["phase_s"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------- #
# phase 3: the flash gradient kernel against its plain version                #
# --------------------------------------------------------------------------- #
# ref.flash_bwd_bf16_limits' own check: copies of csrc/flash_attention_bwd.cu,
# each broken in one line (what it breaks, the line, its replacement),
# which the limit must refuse at SmolLM-135M's bf16 training attention
FLASH_BWD_MUTANTS = (
    ("drops the second key tile from dK and dV",
     "      wg::to_a_frags(pa, st);\n",
     "      if (k_start == kRows)\n"
     "        for (int e = 0; e < 32; ++e) st[e] = 0.f;  // P^T, so dS^T too\n"
     "      wg::to_a_frags(pa, st);\n"),
    ("leaves D out of the first key tile's dS for dQ",
     "      sacc[e] = pr * (dpacc[e] - dl[r]);  // dS\n",
     "      sacc[e] = pr * (dpacc[e] - (kt == 0 ? 0.f : dl[r]));  // dS\n"),
)
BWD_F32_RTOL = 1e-4   # float32 (3xTF32) gradient: |err| <= rtol |want| + ...
BWD_F32_ATOL = 1e-5   # ... atol max|want| of the tensor
# (B, Sq, Sk, H, Hkv, D, causal, window): SmolLM-135M's training attention
# first (the main path's shape), then a long windowed sequence, GQA groups
# 1 and 4, non-causal Sq != Sk, a ragged S, whisper-small's three
# attentions as phase 13 trains them (the encoder's 1,500 frames leave a
# partial key tile; the cross attention has Sq != Sk), and D = 256:
# recurrentgemma-9b's local attention as phase 13 trains it (16 heads on
# one kv head, window 2048) and a non-causal case
FLASH_BWD_CASES = (
    ("smollm-135m train", (8, 512, 512, 9, 3, 64, True, 0)),
    ("long windowed", (1, 4096, 4096, 4, 1, 64, True, 512)),
    ("group 1", (2, 512, 512, 4, 4, 64, True, 0)),
    ("group 4", (2, 512, 512, 8, 2, 64, True, 0)),
    ("non-causal Sq != Sk", (2, 384, 512, 8, 2, 64, False, 0)),
    ("ragged S", (2, 300, 300, 9, 3, 64, True, 0)),
    ("whisper encoder", (4, 1500, 1500, 12, 12, 64, False, 0)),
    ("whisper decoder", (4, 448, 448, 12, 12, 64, True, 0)),
    ("whisper cross", (4, 448, 1500, 12, 12, 64, False, 0)),
    ("recurrentgemma local", (2, 2560, 2560, 16, 1, 256, True, 2048)),
    ("non-causal D=256", (2, 384, 512, 8, 2, 256, False, 0)),
)
# the cases timed (and, for the first two, the forward's LSE beside)
FLASH_BWD_TIMED = ("smollm-135m train", "long windowed", "whisper encoder",
                   "whisper decoder", "whisper cross", "recurrentgemma local",
                   "non-causal D=256")


def build_bwd_mutants() -> list:
    """The entry points of FLASH_BWD_MUTANTS, built side by side in a
    temporary directory (removed once they are loaded)."""
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(len(FLASH_BWD_MUTANTS)) as pool:
        return list(pool.map(
            lambda i: build_variant(
                "flash_attention_bwd", *FLASH_BWD_MUTANTS[i][1:],
                os.path.join(tmp, f"flash_bwd_mutant{i}.cu"),
                "flash_attention_bwd"), range(len(FLASH_BWD_MUTANTS))))


def build_before(root: str) -> dict:
    """The SSD, flash and RG-LRU forwards' and the three gradient entry
    points of the checkout at ``root`` (``python3 chip_smoke.py --before
    DIR``: the sources these kernels replaced, timed beside them), built
    side by side with each library's flags and ``root``'s own headers,
    into a temporary directory removed once they are loaded; "rglru" is
    the pair (rglru_bsw, rglru_tokens), called with this source's packed
    arguments (a parent whose RglruArgs differ fails its first call). The
    SSD forward's is called as
    this source's ``ssd_scan`` is, (args, scratch, stream), also where the
    earlier source takes no scratch; the flash forward's takes this
    source's packed arguments (FlashArgs is unchanged)."""
    from repro_torch.kernels import _build
    csrc = os.path.join(root, "src", "repro_torch", "kernels", "csrc")
    tmp = tempfile.mkdtemp()

    def one(name):
        out = os.path.join(tmp, f"before_{name}.so")
        src = os.path.join(csrc, f"{name}.cu")
        proc = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", csrc,
             *_build.LIBRARY_FLAGS[name], "-o", out, src],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {root}'s {name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        if name == "rglru":   # both entries, the parent's arguments
            lib = ctypes.CDLL(out)
            fns = tuple(getattr(lib, e) for e in ("rglru_bsw", "rglru_tokens"))
            for f in fns:
                f.argtypes, f.restype = _build.SIGNATURES[name]["rglru_bsw"]
            return name, fns
        entry = {"ssd": "ssd_scan",
                 "flash_attention": "flash_attention_bshd"}.get(name, name)
        fn = getattr(ctypes.CDLL(out), entry)
        fn.argtypes, fn.restype = _build.SIGNATURES[name][entry]
        with open(src) as f:
            two_args = "ssd_scan(const SsdArgs* a, void* stream)" in f.read()
        if two_args:   # no scratch: one launch at every shape
            fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
            return name, lambda args, scratch, stream: fn(args, stream)
        return name, fn

    names = ["ssd", "flash_attention", "flash_attention_bwd", "rglru_bwd",
             "ssd_bwd", "rglru"]
    try:
        with ThreadPoolExecutor(6) as pool:
            return dict(pool.map(one, names))
    finally:
        shutil.rmtree(tmp)


def share_of(got, want, limit: torch.Tensor) -> float:
    """The largest share of its limit that an element's error takes (0
    where both are 0)."""
    diff = (got.float() - want.float()).abs()
    return float(torch.where(diff == 0, torch.zeros_like(diff),
                             diff / limit).max())


class BwdCase:
    """One flash gradient case on the card, inputs from a numpy seed in
    the model's (B, S, H, D) layout: the forward through the kernel (with
    its LSE), a cotangent dO, and the plain version's (dQ, dK, dV) in the
    kernels' (BH, S, D) layout with its per-element bf16 limits."""

    def __init__(self, shape: tuple, dtype, seed: int = 31):
        from repro_torch.kernels import flash_attention, ref
        b, sq, sk, h, hkv, d, causal, window = shape
        rng = np.random.default_rng(seed)

        def T(*dims):
            return torch.from_numpy(rng.standard_normal(dims).astype(
                np.float32)).cuda().to(dtype)

        self.shape, self.dtype = shape, dtype
        self.q, self.k, self.v = T(b, sq, h, d), T(b, sk, hkv, d), T(b, sk, hkv, d)
        self.dout = T(b, sq, h, d)
        self.kw = {"causal": causal, "window": window}
        self.group = h // hkv
        self.out, self.lse = flash_attention._forward(
            self.q, self.k, self.v, "bshd", self.group, causal, window,
            d ** -0.5, with_lse=True)
        self.args = [bhsd(t) for t in (self.q, self.k, self.v, self.out,
                                       self.dout)]
        self.want = ref.flash_attention_bwd(*self.args, group=self.group,
                                            **self.kw)
        self.limits = (ref.flash_bwd_bf16_limits(
            *self.args, self.want, group=self.group, **self.kw)
            if dtype == torch.bfloat16 else None)

    def grads(self):
        """(dQ, dK, dV) through the autograd function (one backward
        launch), in the (BH, S, D) layout."""
        from repro_torch.kernels import flash_attention
        leaves = [t.clone().requires_grad_() for t in (self.q, self.k, self.v)]
        out = flash_attention.flash_attention_bshd(*leaves, **self.kw)
        return [bhsd(g) for g in torch.autograd.grad(out, leaves, self.dout)]

    def entry_args(self, outs) -> bytes:
        """The gradient entry point's packed arguments, writing ``outs``
        ((B, S, H, D) dQ, dK, dV) and a scratch D of its own, kept as long
        as the case."""
        from repro_torch.kernels import flash_attention
        b, sq, sk, h, hkv, d, causal, window = self.shape
        self.delta = torch.empty_like(self.lse)
        self.deltas = getattr(self, "deltas", []) + [self.delta]
        ts = (self.q, self.k, self.v, self.out, self.dout, *outs)
        return flash_attention.pack_bwd_args(
            self.q, self.k, self.v, self.out, self.dout, self.lse,
            self.delta, *outs,
            [flash_attention.bshd_layout(t) for t in ts], b, h, self.group,
            sq, sk, causal, window, d ** -0.5)

    def check(self, got) -> dict:
        """Each of (dQ, dK, dV) against the plain version: float32 within
        BWD_F32_RTOL |want| + BWD_F32_ATOL max|want|, bf16 within its
        limits; no NaN. Returns the largest error and share."""
        err, share, ok = 0.0, 0.0, True
        for g, w, i in zip(got, self.want, range(3)):
            diff = (g.float() - w.float()).abs()
            err = max(err, float(diff.max()))
            ok = ok and not bool(torch.isnan(g).any())
            if self.limits is None:
                lim = BWD_F32_RTOL * w.abs() + BWD_F32_ATOL * w.abs().max()
            else:
                lim = self.limits[i]
            share = max(share, share_of(g, w, lim))
        ok = ok and share <= 1.0
        return {"max_abs_err": err, "largest_share_of_limit": share,
                "within": ok}


def time_flash_bwd(case: BwdCase, label: str, before=None) -> dict:
    """Times of the gradient kernel at ``case``'s shapes: through its
    wrapper (``_launch_bwd``: allocation, checks, one entry call of three
    launches), at its C entry point on preallocated outputs, and of
    scaled_dot_product_attention's backward on the same work (the library
    time: autograd.grad of one SDPA forward), in turns by ``paired_ms``
    with, in bf16 and given ``before`` (``build_before``'s entry points),
    the earlier kernel's entry point (``before_ms``); in bf16 also the
    entry point in a CUDA graph; and the plain version, beside the bound:
    each input (q, k, v, o, dO, LSE) read once and dQ, dK, dV written
    once; 10 flops per visible (query, key) pair and dim (five products:
    s, dP, dV, dQ, dK)."""
    from repro_torch.kernels import _build, flash_attention, ref
    b, sq, sk, h, hkv, d, causal, window = case.shape
    bf16 = case.dtype == torch.bfloat16
    lay = lambda t, kv: flash_attention.bshd_layout(t)  # noqa: E731
    wrapper = lambda: flash_attention._launch_bwd(  # noqa: E731
        case.q, case.k, case.v, case.out, case.dout, case.lse, lay, b, h,
        case.group, sq, sk, causal, window, d ** -0.5)
    outs = [torch.empty_like(t) for t in (case.q, case.k, case.v)]
    args = case.entry_args(outs)
    stream = torch.cuda.current_stream().cuda_stream
    call = _build.load("flash_attention_bwd").lib.flash_attention_bwd
    if call(args, stream) != 0:
        raise AssertionError("flash_attention_bwd entry point failed")
    leaves = [t.transpose(1, 2).detach().requires_grad_()
              for t in (case.q, case.k, case.v)]
    if window > 0:
        i = torch.arange(sq, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        sdpa = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                              enable_gqa=True)
    else:
        sdpa = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              enable_gqa=True)
    dout4 = case.dout.transpose(1, 2)
    library = lambda: torch.autograd.grad(  # noqa: E731
        sdpa, leaves, dout4, retain_graph=True)
    fns = {"ms": wrapper, "entry_ms": lambda: call(args, stream),
           "library_ms": library}
    if before is not None and bf16:
        old_args = case.entry_args([torch.empty_like(t) for t in outs])
        old = before["flash_attention_bwd"]
        fns["before_ms"] = lambda: old(old_args, stream)
    before_launches = flash_attention.backward_launches
    t = {"dtype": str(case.dtype).replace("torch.", ""),
         **paired_ms(fns, iters=20 if d <= 128 else 4)}
    if bf16:
        t["graph_ms"] = graph_ms(lambda st: call(args, st), n=20, reps=5)
    flash_attention.backward_launches = before_launches  # timing calls do not count
    t["plain_ms"] = time_ms(lambda: ref.flash_attention_bwd(
        *case.args, group=case.group, **case.kw), 3, warmup=1)
    elt = case.q.element_size()
    nbytes = (4 * case.q.numel() + 4 * case.k.numel()) * elt \
        + case.lse.numel() * 4
    pairs = visible_pairs(sq, causal, window, sk) * b * h
    t.update(tensor_core_bound(nbytes, 10.0 * pairs * d, case.dtype))
    extra = (f", in a CUDA graph {t['graph_ms']!r} ms" if bf16 else "") + (
        f", the earlier kernel's entry point {t['before_ms']!r} ms"
        if "before_ms" in t else "")
    print(f"  flash_attention_bwd {label}: kernel {t['ms']!r} ms (entry "
          f"point {t['entry_ms']!r} ms{extra}), plain {t['plain_ms']!r} ms, "
          f"scaled_dot_product_attention backward {t['library_ms']!r} ms, "
          f"bound {t['bound_ms']!r} ms ({t['bound_by']}; float32 CUDA cores "
          f"{t['bound_f32_cores_ms']!r} ms)", flush=True)
    return t


def time_flash_lse(case: BwdCase, label: str) -> dict:
    """The forward kernel at ``case``'s shapes with and without its LSE
    output, in turns (``paired_ms``)."""
    from repro_torch.kernels import flash_attention
    b, sq, sk, h, hkv, d, causal, window = case.shape
    before = flash_attention.launches
    t = paired_ms({
        "no_lse_ms": lambda: flash_attention._forward(
            case.q, case.k, case.v, "bshd", case.group, causal, window,
            d ** -0.5, with_lse=False),
        "lse_ms": lambda: flash_attention._forward(
            case.q, case.k, case.v, "bshd", case.group, causal, window,
            d ** -0.5, with_lse=True)}, iters=50)
    flash_attention.launches = before   # timing calls do not count
    print(f"  flash_attention forward {label}: {t['no_lse_ms']!r} ms "
          f"without the LSE, {t['lse_ms']!r} ms with it", flush=True)
    return t


def flash_bwd_cases(mutants: list, before=None) -> dict:
    """Phase 3 for the gradient kernel: FLASH_BWD_CASES in bf16 and
    float32 through the autograd function against ref.flash_attention_bwd,
    the kernel bit-equal on a second run (no atomics) and on the design
    it should take (``flash_attention_bwd_route``: bf16 the wgmma
    instances fed by TMA, these operands being aligned; float32 the
    mma.sync ones), both FLASH_BWD_MUTANTS refused by the bf16 limit at
    the main path's shape, every case bit-equal to ``before``'s entry
    point on the same arguments (given), and the kernel (beside
    ``before``'s) and the forward's LSE timed. Returns {"cases",
    "mutants", "timings", "lse"}."""
    from repro_torch.kernels import _build, flash_attention
    route_of = _build.load("flash_attention_bwd").lib.flash_attention_bwd_route
    routes = flash_attention.ROUTES   # the gradient's route answers alike
    out = {"cases": {}, "mutants": {}, "timings": {}, "lse": {}}
    bf16, f32 = torch.bfloat16, torch.float32
    stream = torch.cuda.current_stream().cuda_stream
    for name, shape in FLASH_BWD_CASES:
        for dt in (bf16, f32):
            b, sq, sk, h, hkv, d, causal, window = shape
            label = (f"{name} B={b} Sq={sq} Sk={sk} H={h} Hkv={hkv} D={d} "
                     f"causal={causal} window={window} "
                     f"{'bf16' if dt == bf16 else 'f32'}")
            case = BwdCase(shape, dt)
            got = case.grads()
            again = case.grads()
            res = case.check(got)
            res["bit_equal_rerun"] = all(torch.equal(a, c)
                                         for a, c in zip(got, again))
            res["route"] = routes.get(route_of(case.entry_args(
                [torch.empty_like(t) for t in (case.q, case.k, case.v)])))
            print(f"  flash_attention_bwd {label}: max_abs_err "
                  f"{res['max_abs_err']!r}, largest share of its limit "
                  f"{res['largest_share_of_limit']!r}, bit-equal on a rerun "
                  f"{res['bit_equal_rerun']}, {res['route']}", flush=True)
            if res["route"] != routes[2 if dt == bf16 else 0]:
                raise AssertionError(f"the flash gradient took another "
                                     f"design on {label}: {res['route']}")
            if not (res["within"] and res["bit_equal_rerun"]):
                raise AssertionError(f"the flash gradient kernel disagrees "
                                     f"on {label}")
            if before is not None:
                # the earlier source fed the same arguments (this forward's
                # o and LSE) gives the same bits: the gradient's device
                # code is as it was
                mine = [torch.empty_like(t) for t in (case.q, case.k, case.v)]
                old = [torch.empty_like(t) for t in mine]
                if (_build.load("flash_attention_bwd").lib.flash_attention_bwd(
                        case.entry_args(mine), stream) != 0
                        or before["flash_attention_bwd"](
                            case.entry_args(old), stream) != 0):
                    raise AssertionError("flash_attention_bwd entry failed")
                torch.cuda.synchronize()
                res["bit_equal_to_before"] = all(
                    torch.equal(a, c) for a, c in zip(mine, old))
                print(f"  flash_attention_bwd {label}: bit-equal to the "
                      f"earlier source's {res['bit_equal_to_before']}",
                      flush=True)
                if not res["bit_equal_to_before"]:
                    raise AssertionError(f"the flash gradient differs from "
                                         f"the earlier source's on {label}")
            if name == "smollm-135m train" and dt == bf16:
                for (what, _, _), call in zip(FLASH_BWD_MUTANTS, mutants):
                    outs = [torch.empty_like(t) for t in (case.q, case.k,
                                                          case.v)]
                    if call(case.entry_args(outs), stream) != 0:
                        raise AssertionError(f"the gradient mutant that "
                                             f"{what} failed")
                    torch.cuda.synchronize()
                    m = case.check([bhsd(t) for t in outs])
                    out["mutants"][what] = m
                    print(f"  flash_bwd limit at {label}, the mutant that "
                          f"{what}: max_abs_err {m['max_abs_err']!r}, "
                          f"largest share of the limit "
                          f"{m['largest_share_of_limit']!r}", flush=True)
                    if m["within"]:
                        raise AssertionError(f"the bf16 gradient limit "
                                             f"accepts the mutant that {what}")
            if name in FLASH_BWD_TIMED:
                out["timings"][label] = {**time_flash_bwd(case, label,
                                                         before),
                                         "max_abs_err": res["max_abs_err"]}
            if name in FLASH_BWD_TIMED[:2]:
                out["lse"][label] = time_flash_lse(case, label)
            out["cases"][label] = res
            del case
    print(f"  backward launches so far {flash_attention.backward_launches}")
    for line in ptxas_lines("flash_attention_bwd", "_kernel"):
        print(f"  flash_attention_bwd instances (ptxas): {line}")
    return out


# --------------------------------------------------------------------------- #
# phases 12 and 13: training                                                  #
# --------------------------------------------------------------------------- #
TRAIN_SEED = 0
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 10, 25   # phase 12's crash and resume
GATE_GRAD_RTOL = 1e-3        # float32 gradients, kernels against plain:
GATE_GRAD_ATOL = 1e-3        # ... and this times the leaf's largest
# Each family trains in bf16 with remat, AdamW as build makes it. Phase 12
# trains the first: smollm-135m unreduced (30 layers) at 8 x 512 (the JAX
# example's --full-config) through train_loop. Phase 13 the others:
# whisper-small unreduced (12 + 12 layers, 1,500 frames) at its decoder's
# context of 448, driven through build's step (train_loop feeds tokens
# only, as the reference's does); recurrentgemma-9b at full width cut to 4
# of its 38 layers (a (rglru, rglru, local) group and a remainder RG-LRU
# block, so both loops train: the whole model's AdamW state alone would
# not fit one card) at 2 x 2560 (its window of 2048 binds), driven
# through train_loop; mamba2-370m unreduced (48 layers) at 4 x 512 (the
# shape phase 10's forward runs) through train_loop, for as few steps as
# show the loss falling (each step takes its 96 ssd forward launches,
# ~58 ms each at these widths), its step timed in 2 rounds, not
# FAMILY_ROUNDS (a step is ~5.8 s, the device busy 99.5% of it). Launches a step under remat: each
# attention, RG-LRU or SSD layer's forward, its recompute and its
# gradient. The float32 gate cuts the same draws (smollm and mamba2 to 2
# layers, whisper to 2 + 2, recurrentgemma to its group at one row); its
# launches a pass (gradients, then a step) as a step's.
TRAIN_FAMILIES = (
    {"arch": "smollm-135m", "changes": {}, "shape": (8, 512), "steps": 40,
     "a_step": {"flash_attention": 60, "flash_attention_bwd": 30},
     "gate": {"num_layers": 2}, "gate_shape": (8, 512),
     "gate_a_pass": {"flash_attention": 4, "flash_attention_bwd": 2}},
    {"arch": "whisper-small", "changes": {}, "shape": (4, 448), "steps": 40,
     "a_step": {"flash_attention": 72, "flash_attention_bwd": 36},
     "gate": {"num_layers": 2, "num_encoder_layers": 2},
     "gate_shape": (4, 448),
     "gate_a_pass": {"flash_attention": 12, "flash_attention_bwd": 6}},
    {"arch": "recurrentgemma-9b", "changes": {"num_layers": 4},
     "shape": (2, 2560), "steps": 20,
     "a_step": {"flash_attention": 2, "flash_attention_bwd": 1, "rglru": 6,
                "rglru_bwd": 3},
     "gate": {"num_layers": 3}, "gate_shape": (1, 2560),
     "gate_a_pass": {"flash_attention": 2, "flash_attention_bwd": 1,
                     "rglru": 4, "rglru_bwd": 2}},
    {"arch": "mamba2-370m", "changes": {}, "shape": (4, 512), "steps": 8,
     "a_step": {"ssd": 96, "ssd_bwd": 48}, "rounds": 2,
     "gate": {"num_layers": 2}, "gate_shape": (4, 512),
     "gate_a_pass": {"ssd": 4, "ssd_bwd": 2}},
)


class _Annotated:
    """An optimizer whose update runs inside a profiler range named
    "optimizer", so that a trace can tell its kernels apart."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return self.inner.init(params)

    def global_norm(self, tree):
        return self.inner.global_norm(tree)

    def update(self, grads, state, params):
        with torch.profiler.record_function("optimizer"):
            return self.inner.update(grads, state, params)


def train_trace(step, params, state, batch) -> dict:
    """One train step under torch.profiler: device time by flash forward
    (flash_kernel, flash_wgmma_kernel, flash_shared_kernel), flash
    backward (the D, dq and dkv
    kernels of both designs), RG-LRU forward (rglru_kernel,
    rglru_pipe_kernel) and backward (rglru_bwd kernels), SSD forward (ssd_kernel, or the three ssd_fwd
    kernels) and backward (the four ssd_bwd kernels), GEMMs, the
    optimizer (the kernels inside the device's span of
    ``_Annotated.update``'s range: one stream runs them in order) and the
    other elementwise and copy kernels, with the busy share of the step's
    wall time; with the hybrid family, its ``rglru_bsw`` calls
    (``rglru_calls``, forward and recompute)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with rglru_scopes(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        warm_up_profiler()
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    split, count = collections.Counter(), collections.Counter()
    # the optimizer's range shows on the device too, as an annotation
    spans = [e.time_range for e in prof.events()
             if e.name == "optimizer" and e.device_type == DeviceType.CUDA]
    if not spans:
        raise AssertionError("the trace holds no device span of the "
                             "optimizer's range")
    events = list(prof.events())
    warm = warm_up_ids(events)
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in (
                "optimizer", RGLRU_SCOPE, PROFILER_WARM_UP) or e.id in warm:
            continue
        name = e.name
        r = e.time_range
        if any(o.start <= r.start and r.end <= o.end for o in spans):
            key = "optimizer"
        elif any(k in name for k in ("dq_kernel", "dkv_kernel",
                                     "delta_kernel", "dq_wgmma_kernel",
                                     "dkv_wgmma_kernel", "delta_vec_kernel")):
            key = "flash_backward"
        elif any(k in name for k in ("flash_kernel", "flash_wgmma_kernel",
                                     "flash_shared_kernel")):
            key = "flash_forward"
        elif "rglru_bwd" in name:
            key = "rglru_backward"
        elif RGLRU_KERNEL.search(name):
            key = "rglru_forward"
        elif "moe_router_bwd" in name:
            key = "router_backward"
        elif "moe_router" in name:
            key = "router_forward"
        elif "ssd_bwd" in name:
            key = "ssd_backward"
        elif "ssd_kernel" in name or "ssd_fwd_" in name:
            key = "ssd_forward"
        elif any(w in name.lower() for w in ("gemm", "gemv", "cutlass",
                                             "xmma", "nvjet")):
            key = "gemms"
        else:
            key = "elementwise_and_copies"
        split[key] += r.elapsed_us() / 1e3
        count[key] += 1
    device_ms = sum(split.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "split_ms": dict(split),
            "split_launches": dict(count), "rglru_calls": rglru_calls(prof)}


def train_counts() -> dict:
    """The training kernels' launch counters: flash, RG-LRU, SSD and
    router forward and gradient."""
    from repro_torch.kernels import flash_attention, moe_router, rglru, ssd
    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention.backward_launches,
            "rglru": rglru.launches, "rglru_bwd": rglru.backward_launches,
            "ssd": ssd.launches, "ssd_bwd": ssd.backward_launches,
            "moe_router": moe_router.launches,
            "moe_router_bwd": moe_router.backward_launches}


def zero_train_counts() -> None:
    from repro_torch.kernels import flash_attention, moe_router, rglru, ssd
    flash_attention.launches = flash_attention.backward_launches = 0
    rglru.launches = rglru.backward_launches = 0
    ssd.launches = ssd.backward_launches = 0
    moe_router.launches = moe_router.backward_launches = 0


def family_batches(cfg, b: int, s: int, seed: int):
    """A maker of train batches: TokenSource's tokens and labels (seed
    ``seed``) and, for an encdec model, frames drawn from
    ``torch.Generator("cuda").manual_seed(seed)``, all on the card."""
    from repro_torch.data.pipeline import TokenSource, shard_batch
    src = TokenSource(cfg.vocab_size, s, seed=seed)
    gen = torch.Generator("cuda").manual_seed(seed)

    def batch() -> dict:
        out = shard_batch(src.next(b), device="cuda")
        if cfg.family == "encdec":
            out["frames"] = torch.randn((b, cfg.num_frames, cfg.d_model),
                                        generator=gen, device="cuda")
        return out

    return batch


def step_loop(cfg, b: int, s: int, steps: int):
    """``steps`` steps of ``build(cfg)``'s train step from weights drawn
    from ``torch.Generator("cuda").manual_seed(TRAIN_SEED)``, on
    ``family_batches``. Returns (losses, params)."""
    from repro_torch.launch.train import build
    from repro_torch.models.params import stacked
    api, opt, step = build(cfg)
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(
        TRAIN_SEED), device="cuda")
    state = opt.init(stacked(params, api.param_shapes(cfg)))
    batch = family_batches(cfg, b, s, TRAIN_SEED)
    losses = []
    for _ in range(steps):
        params, state, metrics = step(params, state, batch())
        losses.append(float(metrics["loss"]))
    return losses, params


def family_grads(api, cfg, model, batch) -> tuple:
    """(loss, {name: gradient stacked over the layers}) of ``api.loss_fn``
    under torch.autograd."""
    from repro_torch.models.params import get_param, param_leaves, stack_layers
    shapes = list(param_leaves(api.param_shapes(cfg)))
    values = [get_param(model, n) for n, _ in shapes]
    flat = [t for v in values for t in (v if isinstance(v, list) else [v])]
    model.requires_grad_(True)
    loss, _ = api.loss_fn(cfg, model, batch)
    gs = iter(torch.autograd.grad(loss, flat))
    model.requires_grad_(False)
    return float(loss.detach()), {
        n: (stack_layers([next(gs) for _ in v], spec, "cuda")
            if isinstance(v, list) else next(gs))
        for (n, spec), v in zip(shapes, values)}


def family_gate(cfg, fam: dict) -> dict:
    """A family's float32 gate: the unreduced draws (seed TRAIN_SEED)
    in float32, cut by ``fam["gate"]``, one batch at ``fam["gate_shape"]``;
    the loss's gradients and one step of ``build``'s step through the
    kernels against the same through the plain versions
    (``plain_kernels``). Gradients within GATE_GRAD_RTOL |plain| +
    GATE_GRAD_ATOL max|plain| of each leaf (3xTF32 keeps ~1e-6 of each
    product); the stepped parameters within twice the first step's
    learning rate (AdamW's first update is -lr g / (|g| + eps): a gradient
    near 0 may take either sign). The draws wait on the host and each pass
    frees its model, so that a 4 GB float32 embedding of recurrentgemma's
    fits beside its copies."""
    import dataclasses
    from repro_torch.launch.train import build
    from repro_torch.models.params import param_leaves, set_param, stacked
    from repro_torch.models.registry import model_api
    full = dataclasses.replace(cfg, dtype="float32")
    cut = dataclasses.replace(full, **fam["gate"])
    api = model_api(cut)
    drawn = api.init_params(full, torch.Generator("cuda").manual_seed(
        TRAIN_SEED), device="cuda")
    draws = {n: t.cpu() for n, t in stacked(drawn, api.param_shapes(full)
                                            ).items()}
    del drawn
    torch.cuda.empty_cache()
    shapes = api.param_shapes(cut)
    batch = family_batches(cut, *fam["gate_shape"], TRAIN_SEED)()

    def model():
        m = api.Model(cut, device="cuda")
        with torch.no_grad():
            for name, spec in param_leaves(shapes):
                value = draws[name]
                set_param(m, name, value[:spec.shape[0]] if "." in name
                          else value)
        return m

    def stepped():
        m = model()
        _, opt, step = build(cut)
        step(m, opt.init(stacked(m, shapes)), batch)
        return stacked(m, shapes), float(opt.schedule(torch.tensor(1)))

    marks = [train_counts()]   # around each pass
    k_loss, k_grads = family_grads(api, cut, model(), batch)
    marks.append(train_counts())
    with plain_kernels():
        p_loss, p_grads = family_grads(api, cut, model(), batch)
    marks.append(train_counts())
    worst = 0.0
    for name, w in p_grads.items():
        if w.numel():   # the cut's empty remainder stack has none
            lim = GATE_GRAD_RTOL * w.abs() + GATE_GRAD_ATOL * w.abs().max()
            worst = max(worst, share_of(k_grads[name], w, lim))
    del k_grads, p_grads
    k_params, lr1 = stepped()
    k_params = {n: t.cpu() for n, t in k_params.items()}
    marks.append(train_counts())
    with plain_kernels():
        p_params, _ = stepped()
    marks.append(train_counts())

    def passes(first: int) -> dict:
        """Launches in passes ``first`` and ``first + 2`` (the kernels' or
        the plain versions')."""
        out = {k: sum(marks[i + 1][k] - marks[i][k] for i in (first,
                                                              first + 2))
               for k in marks[0]}
        return {k: v for k, v in out.items() if v}

    launched, plain_launched = passes(0), passes(1)
    worst_p = max(float((k_params[n] - p_params[n].cpu()).abs().max())
                  for n in k_params if p_params[n].numel())
    del k_params, p_params, draws
    torch.cuda.empty_cache()
    want = {k: 2 * v for k, v in fam["gate_a_pass"].items()}
    res = {"changes": fam["gate"], "shape": list(fam["gate_shape"]),
           "loss": k_loss, "plain_loss": p_loss, "launches": launched,
           "largest_grad_share_of_limit": worst,
           "params_max_abs_err": worst_p, "params_limit": 2 * lr1}
    print(f"  float32 gate ({fam['gate']} at {fam['gate_shape']}): loss "
          f"{k_loss!r} through the kernels, {p_loss!r} through the plain "
          f"versions; gradients' largest share of their limit {worst!r}; "
          f"stepped parameters' max_abs_err {worst_p!r} (limit 2 lr = "
          f"{2 * lr1!r}); launches {launched} (want {want})", flush=True)
    if launched != want or plain_launched:
        raise AssertionError(f"the float32 gate launched {launched} through "
                             f"the kernels and {plain_launched} through the "
                             f"plain versions, not {want} and none")
    if not (worst <= 1.0 and worst_p <= 2 * lr1
            and abs(k_loss - p_loss) <= 1e-4 * abs(p_loss)):
        raise AssertionError(f"{cfg.name}: the float32 train step through "
                             "the kernels disagrees with the plain versions")
    return res


def two_step_bits(cfg, b: int, s: int) -> dict:
    """The parameters after two steps of ``step_loop``, on the host."""
    from repro_torch.models.params import stacked
    from repro_torch.models.registry import model_api
    _, params = step_loop(cfg, b, s, 2)
    out = {n: t.cpu() for n, t in stacked(
        params, model_api(cfg).param_shapes(cfg)).items()}
    del params
    torch.cuda.empty_cache()
    return out


def run_train_family(fam: dict) -> dict:
    """One family of phase 13 in bf16 with remat, AdamW as ``build`` makes
    it: ``fam["steps"]`` steps with the training counters set to 0 just
    before and read just after (each step's launches exact), a falling
    loss, the step's peak memory; the float32 gate; two steps run twice
    from the same draws to the same parameter bits; a step's times,
    tokens/s and torch.profiler split on the trained parameters."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build, train_loop
    from repro_torch.models.params import stacked
    from repro_torch.models.registry import model_api
    cfg = dataclasses.replace(get_config(fam["arch"]), **fam["changes"])
    api = model_api(cfg)
    b, s = fam["shape"]
    steps = fam["steps"]
    enc = (f" + {cfg.num_encoder_layers} encoder, {cfg.num_frames} frames"
           if cfg.num_encoder_layers else "")
    print(f"  {cfg.name} ({cfg.family}): {cfg.num_layers} layers{enc}, "
          f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} "
          f"of {cfg.head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"remat={cfg.remat}; {api.param_count(cfg)} parameters; batch "
          f"{b} x {s}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    t0 = time.perf_counter()
    if cfg.family == "encdec":
        losses, params = step_loop(cfg, b, s, steps)
    else:
        run = train_loop(cfg, steps=steps, batch=b, seq=s, seed=TRAIN_SEED,
                         log_every=steps, device="cuda")
        losses, params = run["losses"], run.pop("params")
        del run
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {k: v for k, v in train_counts().items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: steps * v for k, v in fam["a_step"].items()}
    print(f"  {steps} steps in {loop_s!r} s; loss {losses[0]!r} -> "
          f"{losses[-1]!r}; launches {launches} (want {want}); peak memory "
          f"{peak_gb!r} GB", flush=True)
    if launches != want:
        raise AssertionError(f"{cfg.name}: the steps launched {launches}, "
                             f"not {want}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{cfg.name}: the loss did not fall")

    # a step's times, memory and device split, on the trained params
    _, opt, _ = build(cfg)
    step = api.make_train_step(cfg, _Annotated(opt))
    state = opt.init(stacked(params, api.param_shapes(cfg)))
    batch = family_batches(cfg, b, s, TRAIN_SEED + 1)()
    times = family_ms(lambda: step(params, state, batch),
                      fam.get("rounds", FAMILY_ROUNDS))
    trace = train_trace(step, params, state, batch)
    timing = {**times, "tokens_per_s": b * s / (times["event_ms"] / 1e3),
              "trace": trace}
    print(f"  a train step: {times['event_ms']!r} ms between CUDA events "
          f"({times['host_ms']!r} ms on the host clock), "
          f"{timing['tokens_per_s']!r} tokens/s; one traced step: "
          f"{trace['device_ms']!r} ms of device time in {trace['wall_ms']!r}"
          f" ms (busy share {trace['busy_share']!r}), split "
          f"{trace['split_ms']}, launches {trace['split_launches']}",
          flush=True)
    del params, state, batch, step, opt
    torch.cuda.empty_cache()

    gate = family_gate(cfg, fam)
    t0 = time.perf_counter()
    first, second = two_step_bits(cfg, b, s), two_step_bits(cfg, b, s)
    same = all(torch.equal(first[n], second[n]) for n in first)
    print(f"  two steps from the same draws, run twice: the same parameter "
          f"bits {same} ({time.perf_counter() - t0!r} s)", flush=True)
    if not same:
        raise AssertionError(f"{cfg.name}: two runs of the same steps "
                             "differ")
    return {"arch": cfg.name, "changes": fam["changes"],
            "params": api.param_count(cfg), "steps": steps, "batch": b,
            "seq": s, "losses": losses, "loop_s": loop_s,
            "launches": launches, "peak_memory_gb": peak_gb, "gate": gate,
            "deterministic": same, "step": timing}


def run_uc4() -> dict:
    """UC4 at its defaults on the card (200 reviews, a 30-step probe):
    the probe's train steps through the flash kernels, then the query
    under every eddy policy against the whole-table oracle. cuBLAS need
    not give a row the same bits in batches of other sizes, so a row
    whose |score| lies within LLM_MARGIN times the largest difference
    between the oracle's batches of 64, 10 and 1 rows may flip."""
    from repro_torch.core.policies import EDDY_POLICIES
    from repro_torch.examples import review_analytics as uc4
    from repro_torch.kernels import flash_attention
    before = (flash_attention.launches, flash_attention.backward_launches)
    t0 = time.perf_counter()
    res = uc4.main(["--device", "cuda"])
    probe_s = time.perf_counter() - t0
    launched = (flash_attention.launches - before[0],
                flash_attention.backward_launches - before[1])
    llm, reviews = res["llm"], res["reviews"]
    kept = [r for r in reviews if r.rating <= 1]
    toks = uc4.pad([r.tokens for r in kept])
    ids = np.array([r.rid for r in kept])
    s64 = llm_scores(llm.fn, toks, 64)
    batch_diff = max(float(np.abs(llm_scores(llm.fn, toks, n) - s64).max())
                     for n in (10, 1))
    margin = LLM_MARGIN * batch_diff
    expect = set(ids[s64 > 0].tolist())
    decided = set(ids[np.abs(s64) > margin].tolist())
    if expect != uc4.oracle(llm, reviews):
        raise AssertionError("UC4's oracle is not the example's")
    runs = {}
    for name in sorted(EDDY_POLICIES):
        rows, _, wall = uc4.run_query(llm, reviews, EDDY_POLICIES[name]())
        got = set(rows)
        wrong = (got ^ expect) & decided
        print(f"  UC4 {name}: {len(got)} rows in {wall!r} s; differing from "
              f"the oracle {len(got ^ expect)}, outside the margin "
              f"{len(wrong)}", flush=True)
        if wrong:
            raise AssertionError(f"UC4, policy {name}: rows outside the "
                                 f"margin differ from the oracle: "
                                 f"{sorted(wrong)[:10]}")
        runs[name] = {"rows": len(got), "wall_s": wall,
                      "differ_inside_margin": len(got ^ expect)}
    print(f"  UC4: probe accuracy {res['accuracy']!r}, {len(expect)} of "
          f"{len(ids)} rows score > 0, batch difference {batch_diff!r}, "
          f"margin {margin!r} with {len(ids) - len(decided)} rows inside "
          f"it; {launched[0]} flash forward and {launched[1]} backward "
          f"launches in the probe and the example's own query "
          f"({probe_s!r} s)", flush=True)
    layers = res["cfg"].num_layers
    if launched[1] != 30 * layers or launched[0] < 30 * layers:
        raise AssertionError(f"UC4's probe launched {launched} (forward, "
                             "backward), not its 30 train steps' kernels")
    return {"accuracy": res["accuracy"], "rows_true": len(expect),
            "batch_diff": batch_diff, "margin": margin, "queries": runs,
            "launches": launched, "probe_and_query_s": probe_s}


def run_train() -> dict:
    """Phase 12: TRAIN_FAMILIES' first (``run_train_family``); then the
    same train_loop crashed at TRAIN_FAIL_AT with checkpoints every
    TRAIN_CKPT_EVERY and resumed to the same final loss; then UC4."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.fault_tolerance import FailureInjector
    from repro_torch.launch.train import train_loop
    fam = TRAIN_FAMILIES[0]
    res = run_train_family(fam)
    cfg = get_config(fam["arch"])
    (b, s), steps, losses = fam["shape"], fam["steps"], res["losses"]

    # crash at TRAIN_FAIL_AT, then resume from the newest checkpoint
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.perf_counter()
        try:
            train_loop(cfg, steps=steps, batch=b, seq=s,
                       seed=TRAIN_SEED, device="cuda",
                       ckpt_dir=ckpt_dir, ckpt_every=TRAIN_CKPT_EVERY,
                       injector=FailureInjector([TRAIN_FAIL_AT]))
            raise AssertionError("the injected failure did not fire")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        resumed = train_loop(cfg, steps=steps, batch=b, seq=s,
                             seed=TRAIN_SEED, device="cuda",
                             ckpt_dir=ckpt_dir, ckpt_every=TRAIN_CKPT_EVERY)
        resume_s = time.perf_counter() - t0
    final, again = losses[-1], resumed["final_loss"]
    bit_equal = final == again and resumed["losses"] == losses[
        -len(resumed["losses"]):]
    print(f"  crash at step {TRAIN_FAIL_AT}, resumed from step "
          f"{steps - len(resumed['losses'])}: final loss {again!r} "
          f"against {final!r} uninterrupted (bit-equal {bit_equal}; "
          f"{resume_s!r} s)", flush=True)
    if abs(again - final) > 1e-4 * abs(final) + 1e-5:
        raise AssertionError("the resumed run's final loss differs")

    torch.cuda.empty_cache()
    uc4 = run_uc4()
    return {**res, "resume": {"final_loss": again, "uninterrupted": final,
                              "bit_equal": bit_equal, "seconds": resume_s},
            "uc4": uc4}


def run_train_families() -> dict:
    """Phase 13: each of TRAIN_FAMILIES but the first, one at a time."""
    out = {}
    for fam in TRAIN_FAMILIES[1:]:
        t0 = time.perf_counter()
        out[fam["arch"]] = run_train_family(fam)
        out[fam["arch"]]["phase_s"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------- #
# phase 17: the moe family trains                                              #
# --------------------------------------------------------------------------- #
# grok-1-314b at full width cut to 1 of its 64 layers, bf16, remat, under
# the optimizer the dry run picks for the whole model (Adafactor: 314 G
# parameters); the step's shape is phase 11's forward's. Launches a layer
# and step: the forward and its recompute, and one gradient call, of
# flash and of the router. grad_accum 0 keeps the dry run's
# train_overrides (8 microbatches at d_model >= 2048) off, as one card's
# batch of 2 wants.
MOE_TRAIN = {"arch": "grok-1-314b", "layers": 1, "shape": (2, 512),
             "steps": 4, "rounds": 3,
             "a_layer": {"flash_attention": 2, "flash_attention_bwd": 1,
                         "moe_router": 2, "moe_router_bwd": 1}}
# arctic-480b's one layer at full width (13.9 G parameters) outgrows the
# card: the dry run says by how much, and arctic reduced with its 128
# experts takes the steps instead
MOE_PREDICTED = (("grok-1-314b", 1), ("arctic-480b", 1))
TRAIN_SCHEDULE = (3e-4, 20, 1000)   # launch.train.build's (lr, warmup, total)
PREDICTION_FLOOR = 0.8   # the dry run's bytes against the card's peak

# the dry run of a step on a (1, 1) fake mesh, in a process of its own:
# argv is (B, S) and then arch:layers pairs; prints one JSON line
DRYRUN_STEP = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh, start_fake_world
b, s = int(sys.argv[1]), int(sys.argv[2])
shape = dataclasses.replace(get_shape("train_4k"), global_batch=b, seq_len=s)
start_fake_world(1)
mesh = make_fake_mesh((1, 1))
out = {}
for pair in sys.argv[3:]:
    arch, layers = pair.split(":")
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=int(layers), grad_accum=0)
    sample, times = dryrun.compile_cell(cfg, shape, mesh,
                                        opt=dryrun.choose_optimizer(full))
    out[pair] = {"mem": sample.mem, "flops": sample.flops,
                 "bytes_accessed": sample.bytes_accessed, "times": times,
                 "optimizer": type(dryrun.choose_optimizer(full)).__name__}
print(json.dumps(out))
"""


def moe_optimizer(full):
    """``choose_optimizer(full)`` (Adafactor for grok's and arctic's 314 G
    and 480 G parameters) on ``build``'s learning-rate schedule: its
    default constant 1e-3 moves every weight of a freshly drawn layer by
    ~5% of its scale a step (Adafactor's update is about the rate itself),
    which sends the loss up (12.6 -> 41.5 in 4 steps, seen on the card)."""
    import dataclasses
    from repro_torch.launch.dryrun import choose_optimizer
    from repro_torch.optim import cosine_schedule
    return dataclasses.replace(choose_optimizer(full),
                               schedule=cosine_schedule(*TRAIN_SCHEDULE))


def dryrun_predictions(b: int, s: int) -> dict:
    """MOE_PREDICTED's steps at (b, s) through the dry run (a fake world
    of one rank, a (1, 1) mesh, fake CUDA tensors: nothing allocated on
    the card, no kernel launched), in a subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", DRYRUN_STEP, str(b), str(s),
         *(f"{a}:{n}" for a, n in MOE_PREDICTED)],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError(f"the dry run of the moe steps failed:\n"
                             f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def moe_gate() -> dict:
    """grok-1 reduced in float32 (2 layers, 4 experts, remat; seed
    TRAIN_SEED): the loss's gradients through the kernels against the
    same through the plain versions (``plain_kernels``), each within
    GATE_GRAD_RTOL |plain| + GATE_GRAD_ATOL max|plain| of its leaf; one
    Adafactor step's parameters within twice its learning rate (a near-0
    gradient may take either sign); launches a pass exact."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.params import stacked
    from repro_torch.models.registry import model_api
    cfg = dataclasses.replace(get_config("grok-1-314b").reduce_for_smoke(),
                              dtype="float32", remat=True)
    api = model_api(cfg)
    shapes = api.param_shapes(cfg)
    opt = moe_optimizer(get_config("grok-1-314b"))
    batch = family_batches(cfg, 2, 128, TRAIN_SEED)()

    def model():
        return api.init_params(cfg, torch.Generator("cuda").manual_seed(
            TRAIN_SEED), device="cuda")

    def stepped():
        m = model()
        api.make_train_step(cfg, opt)(m, opt.init(stacked(m, shapes)), batch)
        return stacked(m, shapes)

    zero_train_counts()
    k_loss, k_grads = family_grads(api, cfg, model(), batch)
    launched = {k: v for k, v in train_counts().items() if v}
    with plain_kernels():
        p_loss, p_grads = family_grads(api, cfg, model(), batch)
        p_params = stepped()
    k_params = stepped()
    worst = 0.0
    for name, w in p_grads.items():
        lim = GATE_GRAD_RTOL * w.abs() + GATE_GRAD_ATOL * w.abs().max()
        worst = max(worst, share_of(k_grads[name], w, lim))
    lr = float(opt.schedule(torch.tensor(1)))
    worst_p = max(float((k_params[n] - p_params[n]).abs().max())
                  for n in k_params)
    want = {k: cfg.num_layers * v for k, v in MOE_TRAIN["a_layer"].items()}
    print(f"  float32 gate (grok-1 reduced, {cfg.num_layers} layers, "
          f"{cfg.num_experts} experts, at (2, 128)): loss {k_loss!r} through "
          f"the kernels, {p_loss!r} through the plain versions; gradients' "
          f"largest share of their limit {worst!r}; Adafactor's stepped "
          f"parameters' max_abs_err {worst_p!r} (limit 2 lr = {2 * lr!r}); "
          f"launches a pass {launched} (want {want})", flush=True)
    if launched != want:
        raise AssertionError(f"the moe gate launched {launched}, not {want}")
    if not (worst <= 1.0 and worst_p <= 2 * lr
            and abs(k_loss - p_loss) <= 1e-4 * abs(p_loss)):
        raise AssertionError("grok-1 reduced: the float32 train step through "
                             "the kernels disagrees with the plain versions")
    return {"loss": k_loss, "plain_loss": p_loss, "launches": launched,
            "largest_grad_share_of_limit": worst,
            "params_max_abs_err": worst_p, "params_limit": 2 * lr}


def arctic_steps(steps: int = 3) -> dict:
    """arctic-480b reduced with its published 128 experts (bf16, remat):
    ``steps`` steps of ``build``'s step, so that a warp-a-row router and
    its gradient go through a train step; launches exact, the loss
    finite."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("arctic-480b").reduce_for_smoke(),
                              num_experts=128, dtype="bfloat16", remat=True)
    zero_train_counts()
    losses, _ = step_loop(cfg, 2, 128, steps)
    launched = {k: v for k, v in train_counts().items() if v}
    want = {k: steps * cfg.num_layers * v
            for k, v in MOE_TRAIN["a_layer"].items()}
    print(f"  arctic-480b reduced, 128 experts: {steps} steps, loss "
          f"{losses[0]!r} -> {losses[-1]!r}, launches {launched} (want "
          f"{want})", flush=True)
    if launched != want or not np.isfinite(losses).all():
        raise AssertionError("arctic-480b reduced: the train steps went "
                             "wrong")
    return {"layers": cfg.num_layers, "experts": cfg.num_experts,
            "losses": losses, "launches": launched}


def run_train_moe(card: str) -> dict:
    """Phase 17: the dry run's prediction of MOE_TRAIN's step (and
    arctic's), then grok-1-314b at full width, 1 of 64 layers, trains on
    the card through the flash and router kernels and their gradients:
    the counters set to 0 just before the steps and read just after
    (launches exact), a falling loss, the peak memory beside the
    prediction (which must be at least PREDICTION_FLOOR of it); a step's
    times, tokens/s and torch.profiler split; the float32 gate
    (``moe_gate``) and arctic reduced's steps (``arctic_steps``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.params import stacked
    from repro_torch.models.registry import model_api
    m = MOE_TRAIN
    b, s = m["shape"]
    full = get_config(m["arch"])
    cfg = dataclasses.replace(full, num_layers=m["layers"], grad_accum=0)
    api = model_api(cfg)
    opt = moe_optimizer(full)
    t0 = time.perf_counter()
    preds = dryrun_predictions(b, s)
    for pair, p in preds.items():
        mem = p["mem"]
        print(f"  dry run of {pair} layer(s) at ({b}, {s}) under "
              f"{p['optimizer']}: arguments {mem['argument_bytes'] / 1e9!r} GB "
              f"+ temporaries {mem['temp_bytes'] / 1e9!r} GB = "
              f"{(mem['argument_bytes'] + mem['temp_bytes']) / 1e9!r} GB a "
              f"card; {p['flops']!r} FLOPs; kernels {mem['kernels']} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    mem = preds[f"{m['arch']}:{m['layers']}"]["mem"]
    predicted = mem["argument_bytes"] + mem["temp_bytes"]
    print(f"  {cfg.name}: {cfg.num_layers} of {full.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_experts} experts of d_ff "
          f"{cfg.d_ff}, top-{cfg.num_experts_per_tok}, {cfg.dtype}, "
          f"remat={cfg.remat}; {api.param_count(cfg)} parameters; "
          f"{type(opt).__name__} ({api.param_count(full)} parameters in the "
          f"whole model); batch {b} x {s}", flush=True)
    torch.cuda.empty_cache()
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(
        TRAIN_SEED), device="cuda")
    state = opt.init(stacked(params, api.param_shapes(cfg)))
    step = api.make_train_step(cfg, opt)
    batch = family_batches(cfg, b, s, TRAIN_SEED)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(m["steps"]):
        params, state, metrics = step(params, state, batch())
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {k: v for k, v in train_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    want = {k: m["steps"] * cfg.num_layers * v
            for k, v in m["a_layer"].items()}
    print(f"  {m['steps']} steps in {loop_s!r} s; loss {losses[0]!r} -> "
          f"{losses[-1]!r}; launches {launches} (want {want}); peak memory "
          f"{peak / 1e9!r} GB against the dry run's {predicted / 1e9!r} GB "
          f"({predicted / peak!r} of it; {card})", flush=True)
    if launches != want:
        raise AssertionError(f"{cfg.name}: the steps launched {launches}, "
                             f"not {want}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{cfg.name}: the loss did not fall")
    if predicted < PREDICTION_FLOOR * peak:
        raise AssertionError(f"the dry run predicted {predicted} bytes, "
                             f"below {PREDICTION_FLOOR} of the card's "
                             f"{peak}")
    timed = api.make_train_step(cfg, _Annotated(opt))
    tbatch = batch()
    times = family_ms(lambda: timed(params, state, tbatch), m["rounds"])
    trace = train_trace(timed, params, state, tbatch)
    timing = {**times, "tokens_per_s": b * s / (times["event_ms"] / 1e3),
              "trace": trace}
    print(f"  a train step: {times['event_ms']!r} ms between CUDA events "
          f"({times['host_ms']!r} ms on the host clock), "
          f"{timing['tokens_per_s']!r} tokens/s, peak {peak / 1e9!r} GB; one "
          f"traced step: {trace['device_ms']!r} ms of device time in "
          f"{trace['wall_ms']!r} ms (busy share {trace['busy_share']!r}), "
          f"split {trace['split_ms']}, launches {trace['split_launches']} "
          f"({card})", flush=True)
    del params, state, step, timed, tbatch
    torch.cuda.empty_cache()
    gate = moe_gate()
    arctic = arctic_steps()
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "params": api.param_count(cfg), "optimizer": type(opt).__name__,
            "steps": m["steps"], "batch": b, "seq": s, "losses": losses,
            "loop_s": loop_s, "launches": launches,
            "peak_memory_bytes": peak, "predicted_bytes": predicted,
            "predictions": preds, "step": timing, "gate": gate,
            "arctic": arctic}


# --------------------------------------------------------------------------- #
# phase 18: the dry run                                                        #
# --------------------------------------------------------------------------- #
DRYRUN_CELL = ("smollm-135m", "train_4k")


def run_dryrun() -> dict:
    """Phase 18: ``python -m repro_torch.launch.dryrun`` for DRYRUN_CELL on
    the single-pod (16, 16) mesh with --roofline, in a subprocess (a fake
    world of 256 ranks; nothing launched on the card): the cell's record
    must be ok, with FLOPs, bytes, a gradient reduction among its
    collectives and temporaries; its terms printed."""
    arch, shape = DRYRUN_CELL
    outdir = os.path.join(ROOT, "chiprun_out", "dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "singlepod", "--roofline", "--force",
         "--outdir", outdir], env=env, capture_output=True, text=True,
        timeout=500, cwd=ROOT)
    wall = time.perf_counter() - t0
    path = os.path.join(outdir, f"{arch}__{shape}__singlepod.json")
    if proc.returncode != 0 or not os.path.exists(path):
        raise AssertionError(f"the dry run failed ({proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    with open(path) as f:
        rec = json.load(f)
    colls = {k: v["count"] for k, v in rec["collectives"].items() if v["count"]}
    terms = rec["roofline"]["terms"]
    print(f"  {arch} {shape} on (16, 16) in {wall:.1f} s: memory "
          f"{rec['memory']}; FLOPs a card {rec['per_device']['flops_scan_once']!r}"
          f", bytes {rec['per_device']['bytes_scan_once']!r}, wire "
          f"{rec['per_device']['wire_bytes_scan_once']!r}; collectives "
          f"{colls}; roofline terms {terms}; useful ratio "
          f"{rec['roofline']['useful_ratio']!r}", flush=True)
    if not (rec["status"] == "ok" and rec["per_device"]["flops_scan_once"] > 0
            and colls.get("all-reduce", 0) + colls.get("reduce-scatter", 0)
            and rec["memory"]["temp_bytes"] > 0):
        raise AssertionError(f"the dry run's record is wrong: {rec}")
    return {"wall_s": wall, "record": rec}


# --------------------------------------------------------------------------- #
# phases 14 and 15: cascade_filter and UC2 + UC3                              #
# --------------------------------------------------------------------------- #
WAREHOUSE_FRAMES = 400   # the example's default
CASCADE_BUCKET = 0.1     # a bucket a tenth of the rows: a few passes


def run_cascade(toks_kept: np.ndarray, ids_kept: np.ndarray,
                expect: set) -> dict:
    """Phase 14: ``core.vectorized.cascade_filter`` over the triage query's
    kept rows on the card, with the counters set to 0 just before and read
    just after: the router predicate's function (``moe_router_tokens``,
    top-1 expert 0) over the whole table, then the SSD scorer's
    (``ssd_bshp``, mean score > 0) on compacted buckets of its survivors
    (CASCADE_BUCKET of the rows a bucket; the zero sentinel row, whose dt
    is 0, pads the last). The mask must equal phase 6's whole-table oracle."""
    from repro_torch.core.vectorized import cascade_filter
    from repro_torch.kernels import moe_router, ssd
    from repro_torch.udfs import library as lib
    dev = torch.device("cuda")
    toks = lib.token_ids(toks_kept, SEQ, VOCAB, dev)
    emb, w_gate = lib.router_tables(device=dev)
    tables = lib.ssd_tables(device=dev)
    buckets = []

    def routed(t):
        return moe_router.moe_router_tokens(t, emb, w_gate, 2)[1][:, 0] == 0

    def scored(t):
        buckets.append(t.shape[0])
        y, _ = ssd.ssd_bshp(*lib.ssd_inputs(tables, t), chunk=SEQ)
        return lib.row_mean(y) > 0

    torch.cuda.synchronize()
    moe_router.launches = ssd.launches = 0
    t0 = time.perf_counter()
    mask = cascade_filter([routed, scored], toks,
                          bucket_fractions=(CASCADE_BUCKET,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {"moe_router": moe_router.launches, "ssd": ssd.launches}
    survivors = int(routed(toks).sum())
    got = set(ids_kept[mask.cpu().numpy()].tolist())
    print(f"  cascade_filter over {len(toks_kept)} rows in {wall!r} s: "
          f"{survivors} routed to expert 0, the SSD scan on {len(buckets)} "
          f"buckets of {buckets[0] if buckets else 0} rows; {len(got)} rows "
          f"(the oracle {len(expect)}); launches {launched}", flush=True)
    if got != expect:
        raise AssertionError(f"cascade_filter's mask differs from the "
                             f"whole-table mask: {sorted(got ^ expect)[:10]}")
    if launched != {"moe_router": 1, "ssd": len(buckets)} or not buckets:
        raise AssertionError(f"cascade_filter launched {launched} for "
                             f"{len(buckets)} buckets")
    return {"rows": len(toks_kept), "survivors": survivors,
            "buckets": buckets, "matched": len(got), "wall_s": wall,
            "launches": launched}


def run_warehouse() -> dict:
    """Phase 15: UC2 + UC3 (``examples.warehouse_safety``) at its defaults
    on the CPU (the kernel's plain version), then on the card with the
    hsv_color counter set to 0 just before and read just after: Q3's
    unsafe frames under the cost-driven and reuse-aware policies equal the
    ground truth and the CPU run's, the board shows hsv_color launches
    under both, and the reuse-aware run has cache hits."""
    from repro_torch.examples import warehouse_safety as ws
    from repro_torch.kernels import hsv_color
    argv = ["--frames", str(WAREHOUSE_FRAMES)]
    cpu = ws.main([*argv, "--device", "cpu"])
    torch.cuda.synchronize()
    hsv_color.launches = 0
    t0 = time.perf_counter()
    card = ws.main([*argv, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = hsv_color.launches
    runs = {}
    for label in ("cost-driven", "reuse-aware"):
        snap = card[label]["stats"]
        runs[label] = {
            "rows": len(card[label]["rows"]), "wall_s": card[label]["wall_s"],
            "board_launches": int(snap.get("hsv_color", {}).get("batches", 0)),
            "cache_hit_rate": {p: snap[p]["cache_hit_rate"]
                               for p in ("person", "no_hardhat")}}
        if not (card[label]["rows"] == card["expect"] == cpu[label]["rows"]):
            raise AssertionError(f"warehouse Q3, {label}: the card's frames "
                                 "differ from the ground truth or the CPU's")
        if runs[label]["board_launches"] <= 0:
            raise AssertionError(f"warehouse Q3, {label}: no hsv_color "
                                 "launches on the board")
    hits = runs["reuse-aware"]["cache_hit_rate"]
    print(f"  warehouse_safety over {WAREHOUSE_FRAMES} frames on the card "
          f"in {wall!r} s: {len(card['expect'])} unsafe frames under both "
          f"policies (= ground truth = the CPU run); hsv_color launches "
          f"{launched}, on the board {[r['board_launches'] for r in runs.values()]}; "
          f"reuse-aware cache hit rates {hits}", flush=True)
    if launched <= 0 or not any(v > 0 for v in hits.values()):
        raise AssertionError("warehouse_safety: no hsv_color launches or no "
                             "cache hits under the reuse-aware policy")
    return {"frames": WAREHOUSE_FRAMES, "unsafe": len(card["expect"]),
            "launches": launched, "wall_s": wall, "queries": runs}


# --------------------------------------------------------------------------- #
# phase 16: a one-card NCCL mesh                                             #
# --------------------------------------------------------------------------- #
MESH_STEPS = 4    # SmolLM-135M train steps on the mesh and off it
MESH_ROUNDS = 2   # timed forwards on and off the mesh, after a warm-up
MESH_STEP_ROUNDS = 5  # timed train steps after the counted ones, a warm-up
                      # first (DTensor's sharding caches fill over the first)
# (arch, forward (B, S), config changes, each kernel's launches a forward)
# at phases 10's and 11's shapes, bf16, under SERVE_RULES
MESH_FORWARDS = (
    ("mamba2-370m", (4, 512), {}, {"ssd": 48}),
    ("recurrentgemma-9b", (1, 2560), {}, {"rglru": 26, "flash_attention": 12}),
    ("whisper-small", (4, 64), {}, {"flash_attention": 36}),
    ("grok-1-314b", (2, 512), {"num_layers": 6},
     {"flash_attention": 6, "moe_router": 6}),
)


def timed_steps(step, params, state, batches) -> tuple:
    """Each step of ``batches`` between CUDA events (and on the host
    clock), with the training counters set to 0 before each step and read
    after it. Returns (params, losses, per-step ms, per-step host ms,
    per-step launches)."""
    losses, ms, host, launches = [], [], [], []
    for batch in batches:
        zero_train_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        params, state, metrics = step(params, state, batch)
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        ms.append(start.elapsed_time(end))
        launches.append({k: v for k, v in train_counts().items() if v})
        losses.append(float(metrics["loss"]))
    return params, state, losses, ms, host, launches


def mesh_train(mesh) -> dict:
    """SmolLM-135M at full width and depth (bf16, remat, AdamW as
    ``build`` makes it): MESH_STEPS steps of 8 x 512 off the mesh, then the
    same steps from the same draws and batches through
    ``build(cfg, mesh)``; every loss and every parameter bit-equal, each
    step's launches exact; then a step's ms on and off (the median of
    MESH_STEP_ROUNDS after a warm-up, CUDA events) and one traced step
    each for the busy share."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import place_batch
    from repro_torch.distributed.sharding import TRAIN_RULES, plain
    from repro_torch.launch.train import build, place
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.params import stacked
    fam = TRAIN_FAMILIES[0]
    cfg = get_config(fam["arch"])
    b, s = fam["shape"]
    runs = {}
    for where, m in (("off", None), ("on", mesh)):
        api, opt, step = build(cfg, m)
        params = api.init_params(cfg, torch.Generator("cuda").manual_seed(
            TRAIN_SEED), device="cuda")
        state = opt.init(stacked(params, api.param_shapes(cfg)))
        params, state = place(cfg, opt, m, params, state)
        make = family_batches(cfg, b, s, TRAIN_SEED)
        batches = [make() for _ in range(MESH_STEPS)]
        with CommDebugMode() as comm:
            params, state, losses, ms, host, launches = timed_steps(
                step, params, state, batches)
        bad = [n for n in launches if n != fam["a_step"]]
        if bad:
            raise AssertionError(f"mesh {where}: a step launched {bad[0]}, "
                                 f"not {fam['a_step']}")
        kept = {k: plain(v).clone() for k, v in
                stacked(params, api.param_shapes(cfg)).items()}
        # then more steps, timed, and one traced, through the same step
        # with its optimizer in a profiler range (train_trace's split
        # needs it), on one more batch
        traced = api.make_train_step(
            cfg, _Annotated(opt),
            *(() if m is None else (ShardCtx(m, TRAIN_RULES),)))
        batch = make() if m is None else place_batch(make(), m, TRAIN_RULES)
        times = family_ms(lambda: traced(params, state, batch),
                          MESH_STEP_ROUNDS)
        trace = train_trace(traced, params, state, batch)
        runs[where] = {
            "losses": losses, "first_step_ms": ms, "first_host_ms": host,
            "step_ms": times["event_ms"], "host_ms": times["host_ms"],
            "step_ms_rounds": times["event_ms_rounds"],
            "launches": launches,
            "collectives": comm.get_total_counts(),
            "busy_share": trace["busy_share"], "trace": trace,
            "params": kept}
        print(f"  {cfg.name} {MESH_STEPS} steps of {b} x {s} {where} the "
              f"mesh: losses {losses!r} ({ms!r} ms between CUDA events); "
              f"then a step {times['event_ms']!r} ms median of "
              f"{MESH_STEP_ROUNDS} ({times['host_ms']!r} ms on the host "
              f"clock), busy share {trace['busy_share']!r} (a traced step, "
              f"{trace['wall_ms']!r} ms); launches a step {launches[0]}; "
              f"collectives {comm.get_total_counts()}", flush=True)
        del api, opt, step, traced, params, state, batches, batch
        torch.cuda.empty_cache()
    off, on = runs["off"], runs.pop("on")
    off_params, on_params = off.pop("params"), on.pop("params")
    same_params = all(torch.equal(off_params[k], on_params[k])
                      for k in off_params)
    same_loss = off["losses"] == on["losses"]
    diff = on["step_ms"] - off["step_ms"]
    print(f"  on the mesh against off it: losses bit-equal {same_loss}, "
          f"every parameter bit-equal {same_params}; a step "
          f"{diff!r} ms longer on the mesh (DTensor dispatch on the host)",
          flush=True)
    if not (same_loss and same_params):
        raise AssertionError("the mesh's train steps are not bit-equal to "
                             "the same steps off it")
    return {"arch": cfg.name, "steps": MESH_STEPS, "batch": b, "seq": s,
            "off": off, "on": on, "step_ms_difference": diff,
            "launches": {k: sum(n[k] for n in on["launches"])
                         for k in fam["a_step"]}}


def mesh_forward(mesh, arch: str, shape: tuple, changes: dict,
                 want: dict) -> dict:
    """One forward of ``arch`` (bf16, its config's width, ``changes``)
    off the mesh, then the same parameters' storage wrapped as
    ``DTensor``s on the one-card mesh (no copy: the card's allocated bytes
    do not move) and the same forward under SERVE_RULES: bit-equal
    logits, exact launches both times, and each forward's ms."""
    from repro_torch.data.pipeline import place_batch
    from repro_torch.distributed.sharding import SERVE_RULES, plain
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.params import distribute_params
    b, s = shape
    run = (MoeRun if changes else FamilyRun)(arch, "bfloat16", b, s,
                                             **changes)
    cfg, api = run.cfg, run.api
    batch = run.batch(b, s)
    ctx = ShardCtx(mesh, SERVE_RULES)
    # no_grad, not inference_mode: DTensor cannot make an inference-mode
    # view of a parameter made outside it (the conv taps' w[:, j])
    with torch.no_grad():
        zero_launches()
        off = run.forward(batch)
        off_launches = kernel_launches()
        off_ms = family_ms(lambda: run.forward(batch), MESH_ROUNDS)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        distribute_params(run.model, api.param_shapes(cfg),
                          api.param_logical(cfg), SERVE_RULES, mesh)
        placed = place_batch(batch, mesh, SERVE_RULES)
        torch.cuda.synchronize()
        moved = torch.cuda.memory_allocated() - before

        def forward_on():
            out = api.forward(cfg, run.model, placed, ctx)
            return out[0] if isinstance(out, tuple) else out

        zero_launches()
        on = plain(forward_on())
        on_launches = kernel_launches()
        same = torch.equal(on, off)
        on_ms = family_ms(forward_on, MESH_ROUNDS)
    print(f"  {arch}{' ' + str(changes) if changes else ''} forward {b} x "
          f"{s} under SERVE_RULES: logits bit-equal {same}; launches off "
          f"{off_launches}, on {on_launches} (want {want}); bytes allocated "
          f"by the wrapping {moved}; {off_ms['event_ms']!r} ms off, "
          f"{on_ms['event_ms']!r} ms on", flush=True)
    if off_launches != want or on_launches != want:
        raise AssertionError(f"{arch} on the mesh: launches {off_launches} "
                             f"off, {on_launches} on, not {want}")
    if not same:
        raise AssertionError(f"{arch}: the mesh's logits are not bit-equal")
    if moved > 0:
        raise AssertionError(f"{arch}: wrapping the parameters allocated "
                             f"{moved} bytes")
    del run, off, on, placed, batch
    torch.cuda.empty_cache()
    return {"shape": list(shape), "changes": changes, "bit_equal": same,
            "launches": on_launches, "bytes_allocated_by_wrapping": moved,
            "off_ms": off_ms, "on_ms": on_ms}


def run_mesh() -> dict:
    """Phase 16: a world of one NCCL rank started in this process (a
    HashStore, no environment), ``make_host_mesh()`` on it (a (1, 1)
    mesh), SmolLM-135M's train steps (``mesh_train``) and the four other
    families' forwards (``mesh_forward``), then the process group
    destroyed. NCCL failing to start fails the phase."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(device="cuda")
        print(f"  mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
              f"{mesh.device_type}, backend {dist.get_backend()}", flush=True)
        train = mesh_train(mesh)
        forwards = {arch: mesh_forward(mesh, arch, *spec)
                    for arch, *spec in MESH_FORWARDS}
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t0
    # the launches made on the mesh: its train steps and forwards
    launches = collections.Counter(train["launches"])
    for f in forwards.values():
        launches.update(f["launches"])
    print(f"  phase 16 took {seconds!r} s", flush=True)
    return {"train": train, "forwards": forwards, "seconds": seconds,
            "launches": dict(launches)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    before_root = (sys.argv[sys.argv.index("--before") + 1]
                   if "--before" in sys.argv else None)
    from repro_torch.core import AQPExecutor, CostDriven, make_batch
    from repro_torch.core.policies import EDDY_POLICIES
    from repro_torch.data.video import BREEDS, SyntheticVideo
    from repro_torch.data.text import make_reviews
    from repro_torch.examples.lost_dog_query import build_plan, dog_table
    from repro_torch.examples.review_triage import review_table
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
    # the text scores' decision margins are ~1e-7: float32 products stay
    # float32 (the text predicates set this too, and ref.ssd checks it)
    torch.backends.cuda.matmul.allow_tf32 = False

    # ------------------------------------------------------------- 2 build
    phase("2 build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES) + 7) as pool:  # one nvcc a source
        stages = pool.submit(build_ssd_stages)
        mutants = pool.submit(build_flash_mutants)
        grad_mutants = pool.submit(build_bwd_mutants)
        ssd_grad_mutants = pool.submit(build_ssd_mutants, "ssd_bwd",
                                       SSD_BWD_MUTANTS, "ssd_bwd")
        ssd_fwd_mutants = pool.submit(build_ssd_mutants, "ssd",
                                      SSD_FWD_MUTANTS, "ssd_scan")
        earlier = (pool.submit(build_before, before_root) if before_root
                   else None)
        probe_lib = pool.submit(build_flash_probe)
        libs = dict(zip(LIBRARIES, pool.map(_build.load, LIBRARIES)))
        ssd_stages, flash_mutants = stages.result(), mutants.result()
        bwd_mutants = grad_mutants.result()
        ssd_bwd_mutants = ssd_grad_mutants.result()
        ssd_mutants = ssd_fwd_mutants.result()
        before = earlier.result() if earlier else None
        probe_lib = probe_lib.result()
    print(f"  {len(libs)} libraries in {time.perf_counter() - t0:.2f}s")
    for name, lib in libs.items():
        print(f"  {name}: {lib.path.name} built in {lib.seconds:.2f}s")
        for line in lib.log.splitlines():  # ptxas: each instance's use
            if "Compiling entry function" in line:
                print("   ", line.split("'")[1])   # the (mangled) instance
            elif "spill stores" in line or (
                    "ptxas" in line and ("registers" in line or "smem" in line)):
                print("     ", line.strip())

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

    floor_ms = launch_floor_ms()
    timings = {b: time_hsv(hsv_color, ref, hw, rooflines, ranges, b)
               for b in (4, 16, 32, 4096)}

    t0 = time.perf_counter()
    review_list = make_reviews(TRIAGE_REVIEWS, seed=0)
    reviews = review_table(review_list)
    kept = reviews["rating"] <= 2
    toks_kept, ids_kept = reviews["tokens"][kept], reviews["_row_id"][kept]
    print(f"\n  make_reviews({TRIAGE_REVIEWS}, seed=0): {int(kept.sum())} "
          f"rows with rating <= 2, {toks_kept.nbytes / 1e6:.1f} MB of int32 "
          f"tokens at seq {SEQ} ({time.perf_counter() - t0:.2f}s)")
    inputs = TextInputs(toks_kept)
    max_errs = check_text_kernels(inputs)
    max_errs["hsv_color"] = max_err
    text_timings = {b: time_text(inputs, b) for b in (*BUCKETS, BIG)}
    instances = ssd_instances(inputs, ssd_stages, before)
    print()
    att_inputs = AttentionInputs(toks_kept)
    att_errs = check_attention_kernels(att_inputs)
    max_errs.update((k, att_errs[k]) for k in ("flash_attention",
                                                "decode_attention"))
    flash_before = before and before["flash_attention"]
    att_timings = {b: time_attention(att_inputs, b, flash_before)
                   for b in (*BUCKETS, BIG)}
    att_bench = time_attention_bench(flash_before)
    print()
    family_cases = family_kernel_cases(floor_ms, ssd_mutants, before)
    rglru_routes = rglru_route_cases()
    rglru_parent = (rglru_parent_cases(inputs, before)
                    if before is not None else None)
    for name, cases in family_cases.items():
        max_errs[name] = max(max_errs[name], *(t["max_abs_err"]
                                               for t in cases.values()))
    limit_mutants = flash_limit_mutants(flash_mutants)
    flash_instances = flash_sass()
    flash_ticks = flash_probe(probe_lib)
    print()
    flash_bwd = flash_bwd_cases(bwd_mutants, before)
    max_errs["flash_attention_bwd"] = max(
        c["max_abs_err"] for c in flash_bwd["cases"].values())
    print()
    rglru_bwd = rglru_bwd_cases(before)
    max_errs["rglru_bwd"] = max(t["max_abs_err"] for t in rglru_bwd.values())
    print()
    ssd_bwd = ssd_bwd_cases(ssd_bwd_mutants, before)
    max_errs["ssd_bwd"] = max(t["max_abs_err"]
                              for t in ssd_bwd["cases"].values())
    print()
    router_bwd = router_bwd_cases(floor_ms)
    max_errs["moe_router_bwd"] = max(t["max_abs_err"]
                                     for t in router_bwd.values())

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
        timings[main_b] = time_hsv(hsv_color, ref, hw, rooflines, ranges,
                                   main_b)

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

    # ------------------------------------------------------------- 6 triage
    phase(f"6 review triage, make_reviews({TRIAGE_REVIEWS}, seed=0), "
          "expert 0, rating <= 2")
    oracle = triage_oracles(reviews, toks_kept, ids_kept)
    for name, err in (("moe_router", oracle["stats"]["router_weight_max_abs_err"]),
                      ("ssd", oracle["stats"]["score_max_abs_err"])):
        max_errs[name] = max(max_errs[name], err)
    invariance = batch_invariance(toks_kept)
    calls = predicate_calls(toks_kept)
    t0 = time.perf_counter()
    triage = run_triage(reviews, oracle["expect"])
    triage_s = time.perf_counter() - t0

    # ------------------------------------------------------------- 7 registry
    phase("7 text and attention predicates from the registry, each in an "
          "executor")
    registry = run_registry(toks_kept, ids_kept)
    for name in ("flash_attention", "decode_attention"):
        max_errs[name] = max(max_errs[name],
                             registry["oracles"][name]["score_max_abs_err"])

    # ------------------------------------------------------------- 8 service
    phase(f"8 QueryService: triage, attention and decode tenants at once over "
          f"the first {SERVICE_REVIEWS} of make_reviews({TRIAGE_REVIEWS}, "
          "seed=0)")
    served = {r.rid for r in review_list[:SERVICE_REVIEWS]}
    service = run_service(review_list[:SERVICE_REVIEWS], {
        "triage": oracle["expect"] & served,
        "attention": registry["expect"]["flash_attention"] & served,
        "decode": registry["expect"]["decode_attention"] & served})

    # ------------------------------------------------------------- 9 llm
    phase(f"9 the LLM(...) predicate, {LLM_ARCH} at full width, over "
          f"make_reviews({LLM_REVIEWS}, seed=0)")
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    llm_cfg = get_config(LLM_ARCH)
    llm_model = tf.init_params(
        llm_cfg, torch.Generator("cuda").manual_seed(LLM_SEED), device="cuda")
    llm = run_llm(make_reviews(LLM_REVIEWS, seed=0), llm_cfg, llm_model,
                  torch.device("cuda"))
    llm["timings"] = time_llm(llm_cfg, llm_model, llm.pop("udf"),
                              llm.pop("tokens"), flash_before)
    del llm_model
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- 10 families
    phase("10 the ssm, hybrid and encdec families at full width: "
          + ", ".join(f[0] for f in FAMILIES))
    families = run_families()

    # ------------------------------------------------------------- 11 moe
    phase("11 the moe family at full width, cut in depth: "
          + ", ".join(f"{m[0]} ({m[1]} layers)" for m in MOE))
    moe_runs = run_moe_family()

    # ------------------------------------------------------------- 12 train
    dense = TRAIN_FAMILIES[0]
    phase(f"12 training: {dense['arch']} at full width and depth, "
          f"{dense['steps']} steps of {dense['shape'][0]} x "
          f"{dense['shape'][1]}, a crash resumed, then UC4")
    train = run_train()

    # ------------------------------------------------------------- 13 train
    phase("13 train families: "
          + ", ".join(f"{f['arch']} {f['changes'] or 'unreduced'}, "
                      f"{f['steps']} steps of {f['shape'][0]} x "
                      f"{f['shape'][1]}" for f in TRAIN_FAMILIES[1:]))
    train_families = run_train_families()

    # ------------------------------------------------------------- 14 cascade
    phase(f"14 cascade_filter over the triage rows: MoERouter, then SSDScorer "
          f"on compacted buckets")
    cascade = run_cascade(toks_kept, ids_kept, oracle["expect"])

    # ------------------------------------------------------------- 15 UC2+UC3
    phase(f"15 warehouse safety (UC2 + UC3), {WAREHOUSE_FRAMES} frames")
    warehouse = run_warehouse()

    # ------------------------------------------------------------- 16 mesh
    phase("16 a one-card NCCL mesh: SmolLM-135M's train steps through "
          "build(cfg, mesh), the other families' forwards under SERVE_RULES")
    mesh = run_mesh()

    # ------------------------------------------------------------- 17 moe
    phase(f"17 moe training: {MOE_TRAIN['arch']} at full width, "
          f"{MOE_TRAIN['layers']} layer, {MOE_TRAIN['steps']} steps of "
          f"{MOE_TRAIN['shape'][0]} x {MOE_TRAIN['shape'][1]} under the dry "
          "run's optimizer, beside the dry run's memory; a float32 gate; "
          "arctic-480b reduced with 128 experts")
    moe_train = run_train_moe(card)

    # ------------------------------------------------------------- 18 dryrun
    phase(f"18 the dry run: {' '.join(DRYRUN_CELL)} on the (16, 16) mesh "
          "with --roofline")
    dry = run_dryrun()

    # ------------------------------------------------------------- 19 lines
    phase("19 summary")
    main_sizes_text = {**triage["sizes"],
                       "rglru": registry["runs"]["rglru"]["sizes"]}
    text_main = {name: max(c, key=lambda b: (c[b], -b))
                 for name, c in main_sizes_text.items()}
    for name, b in text_main.items():
        if b not in text_timings:
            text_timings[b] = time_text(inputs, b)
    att_main = {name: max(c, key=lambda b: (c[b], -b))
                for name, c in service["sizes"].items()}
    for b in set(att_main.values()) - set(att_timings):
        att_timings[b] = time_attention(att_inputs, b)
    summary = {
        "card": card, "launch_floor_ms": floor_ms, "query": query,
        "query_frames": QUERY_FRAMES,
        "dog_crops": n_dogs, "expected_rows": len(expect),
        "main_launch_sizes": dict(sorted(main_sizes.items())),
        "detector": {"rows": len(got), "wall_s": wall,
                     "launches": det_launches, "sizes": sorted(set(sizes))},
        "timings": {str(b): t for b, t in timings.items()},
        "triage": {"reviews": TRIAGE_REVIEWS, **oracle["stats"],
                   "phase_s": triage_s, **triage},
        "batch_invariance": invariance,
        "predicate_calls": calls,
        "registry": {k: v for k, v in registry.items() if k != "expect"},
        "text_timings": {str(b): t for b, t in text_timings.items()},
        "text_main_batch": text_main,
        "ssd_instances": instances,
        "attention_errors": att_errs,
        "attention_timings": {str(b): t for b, t in att_timings.items()},
        "attention_bench": att_bench,
        "attention_main_batch": att_main,
        "service": service,
        "llm": llm,
        "family_kernel_cases": family_cases,
        "rglru_parent": rglru_parent,
        "rglru_routes": rglru_routes,
        "flash_limit_mutants": limit_mutants,
        "flash_probe": flash_ticks,
        "flash_sass": flash_instances,
        "flash_bwd": flash_bwd,
        "train": train,
        "train_families": train_families,
        "rglru_bwd": rglru_bwd,
        "ssd_bwd": ssd_bwd,
        "cascade": cascade,
        "warehouse": warehouse,
        # registers, shared memory and spills of every gradient instance
        "gradient_ptxas": {name: ptxas_lines(name, "_kernel")
                           for name in ("flash_attention_bwd", "rglru_bwd",
                                        "ssd_bwd")},
        "families": families,
        "moe": moe_runs,
        "mesh": mesh,
        "router_bwd": router_bwd,
        "moe_train": moe_train,
        "dryrun": dry,
        "total_s": time.perf_counter() - t_start,
    }
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    kernels = [{
        "name": "hsv_color", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hsv_color.cu",
        "replaces": "src/repro/kernels/hsv_color.py:64",
        "launches": main_launches + warehouse["launches"],
        "launches_by_path": {"query": main_launches,
                             "warehouse": warehouse["launches"]},
        "max_abs_err": max_err,
        "batch": main_b, **timings[main_b],
        "by_batch": {str(b): t for b, t in sorted(timings.items())},
    }]
    launches = {**triage["launches"], "rglru": registry["launches"]["rglru"]}

    def measured(t: dict) -> dict:
        """A kernel's timings without its other bounds (another entry's,
        ``tk_`` / ``bhcp_`` / ``bsw_bound_ms``, or attention's
        ``bound_f32_cores_ms``): worked out, not measured, they stay in the
        phase-3 lines and chip_smoke.json."""
        return {k: v for k, v in t.items()
                if k in ("bound_ms", "bound_by") or "bound" not in k}

    def family_launches(name: str) -> int:
        """``name``'s launches in phases 10 and 11: each family's (bf16)
        checked forward and decode steps, counted from 0 (the comparison,
        prefill, float32 and timing runs not counted)."""
        return sum(f["forward"]["launches"].get(name, 0)
                   + f["decode"]["steps"] * f["decode"][
                       "launches_a_step"].get(name, 0)
                   for f in (*families.values(), *moe_runs.values()))

    def trained(name: str) -> int:
        """``name``'s launches in the counted training steps of phases 12
        and 13."""
        return sum(f["launches"].get(name, 0)
                   for f in (train, *train_families.values(), moe_train))

    text_path = {"moe_router": "triage", "ssd": "triage",
                 "rglru": "registry"}
    for name, line in (("moe_router", 43), ("ssd", 92), ("rglru", 59)):
        b = text_main[name]
        paths = {text_path[name]: launches[name]}
        if name in COUNTED:
            paths["families"] = family_launches(name)
        if name in ("rglru", "ssd", "moe_router"):
            paths["train"] = trained(name)
        if name in cascade["launches"]:
            paths["cascade"] = cascade["launches"][name]
        if name in mesh["launches"]:
            paths["mesh"] = mesh["launches"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}.py:{line}",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": max_errs[name],
            "batch": b, **measured(text_timings[b][name]),
            "by_batch": {**{str(bb): measured(t[name])
                            for bb, t in text_timings.items()},
                         **{label: measured(t) for label, t in
                            family_cases.get(name, {}).items()}},
        })
    llm_flash = {t["flash_label"]: {**measured(t["flash_attention"]),
                                    "max_abs_err": t["flash_max_abs_err"]}
                 for t in llm["timings"].values()}
    for name, line in (("flash_attention", 91), ("decode_attention", 68)):
        b = att_main[name]
        paths = {"service": service["launches"][name]}
        if name == "flash_attention":
            paths["llm"] = llm["launches"]
            paths["families"] = family_launches(name)
            paths["train"] = trained(name)
            paths["mesh"] = mesh["launches"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}.py:{line}",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": max_errs[name],
            "batch": b, **measured(att_timings[b][name]),
            "by_batch": {**{str(bb): measured(t[name])
                            for bb, t in att_timings.items()},
                         **{label: measured(t[name])
                            for label, t in att_bench.items() if name in t},
                         **(llm_flash if name == "flash_attention" else {}),
                         **{label: measured(t) for label, t in
                            family_cases.get(name, {}).items()}},
        })
    bwd_main = next(iter(flash_bwd["timings"]))   # SmolLM's bf16 training
    paths = {"train": trained("flash_attention_bwd"),
             "mesh": mesh["launches"]["flash_attention_bwd"]}
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
        "launches": sum(paths.values()), "launches_by_path": paths,
        "shape": bwd_main, **measured(flash_bwd["timings"][bwd_main]),
        "max_abs_err": max_errs["flash_attention_bwd"],
        "by_shape": {label: measured(t)
                     for label, t in flash_bwd["timings"].items()},
    })
    rglru_main = next(iter(rglru_bwd))   # no h0: as the model trains
    kernels.append({
        "name": "rglru_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_bwd.cu",
        "replaces": "src/repro/kernels/rglru.py:59",
        "launches": trained("rglru_bwd"),
        "launches_by_path": {"train": trained("rglru_bwd")},
        "shape": rglru_main, **measured(rglru_bwd[rglru_main]),
        "entry_bound_ms": rglru_bwd[rglru_main]["entry_bound_ms"],
        "max_abs_err": max_errs["rglru_bwd"],
        "by_shape": {label: measured(t) for label, t in rglru_bwd.items()},
    })
    ssd_main = next(iter(ssd_bwd["cases"]))   # mamba2's training shape
    kernels.append({
        "name": "ssd_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_bwd.cu",
        "replaces": "src/repro/kernels/ssd.py:92",
        "launches": trained("ssd_bwd"),
        "launches_by_path": {"train": trained("ssd_bwd")},
        "shape": ssd_main, **measured(ssd_bwd["cases"][ssd_main]),
        "max_abs_err": max_errs["ssd_bwd"],
        "by_shape": {label: measured(t)
                     for label, t in ssd_bwd["cases"].items()},
    })
    router_main = next(iter(router_bwd))   # grok-1's (T, E, k)
    kernels.append({
        "name": "moe_router_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_router.cu",
        "replaces": "src/repro/kernels/moe_router.py:43",
        "launches": trained("moe_router_bwd"),
        "launches_by_path": {"train": trained("moe_router_bwd")},
        "shape": router_main, **measured(router_bwd[router_main]),
        "max_abs_err": max_errs["moe_router_bwd"],
        "by_shape": {label: measured(t) for label, t in router_bwd.items()},
    })
    print(f"  chip_smoke.py took {summary['total_s']:.1f} s, builds included")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
