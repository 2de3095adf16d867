"""The port's launch layer (repro_torch.kernels.launch): timing hooks per
launch, token-scoped thread-affine attribution, the no-hooks fast path, the
StatsBoard feed and the watchdog seam — the counterparts of the hook tests
of the JAX package's tests/test_launch.py, run on CPU tensors (backend
"cpu", the port's stand-in for "interpret")."""
import threading

import numpy as np
import pytest
import torch

from repro.kernels import launch as jax_launch
from repro_torch.core.faults import LaunchWatchdog
from repro_torch.core.stats import StatsBoard
from repro_torch.kernels import launch, ops

# small tensors: one intra-op thread, so these tests do not crowd the
# timing-sensitive executor tests running beside them
torch.set_num_threads(1)


def _crops(rng, b=4, h=16, w=8):
    return torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32))


def test_launch_hooks_fire_per_launch(rng):
    events = []
    crops = _crops(rng)
    with launch.launch_hooks(events.append):
        ops.hsv_color_classify(crops)
        ops.hsv_color_classify(crops[:2])
    assert [(e.name, e.backend, e.rows) for e in events] == [
        ("hsv_color", "cpu", 4), ("hsv_color", "cpu", 2)]
    assert all(e.seconds > 0 for e in events)
    ops.hsv_color_classify(crops)  # hook removed on exit
    assert len(events) == 2


def test_stats_board_hook_feeds_record_eval(rng):
    board = StatsBoard([])
    hook = launch.connect_stats_board(board)
    try:
        ops.hsv_color_classify(_crops(rng))
    finally:
        launch.remove_launch_hook(hook)
    st = board["hsv_color"]
    assert st.measured
    assert st.batches == 1
    assert st.tickets == 4            # rows_in == batch size
    assert st.wins == 0               # compute UDF: no rows dropped
    assert st.cost() > 0


def test_stats_board_hook_inherits_cost_alpha(rng):
    board = StatsBoard([], cost_alpha=0.05)
    hook = launch.connect_stats_board(board)
    try:
        ops.hsv_color_classify(_crops(rng))
    finally:
        launch.remove_launch_hook(hook)
    assert board["hsv_color"].cost_per_row.alpha == 0.05


def test_no_hooks_means_no_event_and_no_timing(monkeypatch):
    """The fast path calls the kernel wrapper and returns: no event is
    built, no clock read, no stream waited on."""
    def boom(*a, **k):
        raise AssertionError("fast path touched the timing machinery")

    monkeypatch.setattr(launch, "LaunchEvent", boom)
    monkeypatch.setattr(launch.time, "perf_counter", boom)
    assert launch._snapshot_hooks() == []
    sentinel = object()
    assert launch.kernel_call(lambda x: sentinel, name="k", rows=1)(0) is sentinel


def test_token_hooks_attribute_launches_per_thread(rng):
    crops = _crops(rng, b=2)
    seen = {"a": [], "b": [], "all": []}
    ha = launch.add_launch_hook(seen["a"].append, token="a")
    hb = launch.add_launch_hook(seen["b"].append, token="b")
    hg = launch.add_launch_hook(seen["all"].append)

    def worker(token, n):
        launch.set_launch_context(token)
        for _ in range(n):
            ops.hsv_color_classify(crops)

    try:
        threads = [threading.Thread(target=worker, args=("a", 2)),
                   threading.Thread(target=worker, args=("b", 3))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        ops.hsv_color_classify(crops)  # untagged: global hook only
    finally:
        for h in (ha, hb, hg):
            launch.remove_launch_hook(h)
    assert (len(seen["a"]), len(seen["b"]), len(seen["all"])) == (2, 3, 6)
    assert launch._TOKEN_HOOKS == {}  # emptied token entries are dropped


def test_launch_context_restores_previous_tag():
    launch.set_launch_context("outer")
    try:
        with launch.launch_context("inner"):
            assert launch.current_launch_context() == "inner"
        assert launch.current_launch_context() == "outer"
    finally:
        launch.clear_launch_context()
    assert launch.current_launch_context() is None


def test_watchdog_seam_brackets_kernel_launches(rng):
    wd = LaunchWatchdog(30.0, lambda n, e: None)
    prev = launch.set_launch_watchdog(wd)
    try:
        ops.hsv_color_classify(_crops(rng))
    finally:
        launch.set_launch_watchdog(prev)
    assert wd.began >= 1                   # the launch was bracketed
    assert wd.inflight() == 0              # ... and unbracketed on return
    assert launch.current_launch_watchdog() is prev


def test_thread_stream_and_devices_on_the_cpu():
    with launch.thread_stream("cpu"):
        pass
    assert launch.require_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        launch.require_device("meta")


def test_port_launch_layer_has_the_reference_hook_api():
    """Every hook/context/watchdog name the core and the tests call exists
    in both packages (part (a), the JAX compat shim, has no counterpart)."""
    names = {
        "LaunchEvent", "add_launch_hook", "clear_launch_context",
        "connect_stats_board", "current_launch_context",
        "current_launch_watchdog", "launch_context", "launch_hooks",
        "remove_launch_hook", "set_launch_context", "set_launch_watchdog",
        "stats_board_hook",
    }
    assert all(hasattr(jax_launch, n) for n in names)
    assert all(hasattr(launch, n) for n in names)
    assert set(jax_launch.LaunchEvent.__dataclass_fields__) == set(
        launch.LaunchEvent.__dataclass_fields__)
