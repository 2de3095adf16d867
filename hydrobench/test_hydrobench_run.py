"""Whole runs on the CPU at a reduced size, the harness's look for a card
skipped: a sound run is correct, and a run with the timed path broken
underneath is not; the trace's reduction and the metric readers; on the
card, one short run of the command itself."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

import hb_harness  # noqa: E402

SMALL = {
    "smollm-135m": {"hidden_size": 64, "intermediate_size": 128,
                    "num_attention_heads": 4, "num_key_value_heads": 2,
                    "num_hidden_layers": 2, "vocab_size": 512, "head_dim": 16,
                    "embedding_rows": 512, "torch_dtype": "float32"},
    "mamba2-370m": {"d_model": 64, "n_layer": 2, "headdim": 16, "d_state": 16,
                    "vocab_size": 500, "embedding_rows": 512,
                    "torch_dtype": "float32"},
}
TRAFFIC = {"rows_per_query": {"median": 40, "sigma": 0.5, "min": 16,
                              "max": 120, "deck": 8, "strata": 4}}
SEED = 2**31 + 77


def _run(cell_name, udf_hook=None, seconds=1.0, mix=None):
    """A run of ``cell_name`` at a small size, on the traffic mix ``mix``
    where given (the cell's own where not)."""
    config = cell_name.split(".")[0]
    traffic = dict(TRAFFIC)
    if mix is not None:
        traffic = {**hb_harness.load_json(HERE / "traffic" / f"{mix}.json"),
                   **traffic}
    cell = hb_harness.load_cell(cell_name, False, overrides={
        "cfg": SMALL[config], "traffic": traffic})
    return hb_harness.run_cell(cell, SEED, seconds, False, device="cpu",
                               udf_hook=udf_hook)


@pytest.mark.parametrize("cell,mix", [("smollm-135m.long", None),
                                      ("mamba2-370m.long", "reviews")],
                         ids=["smollm-135m.long", "mamba2-370m.reviews"])
def test_sound_run_is_correct(cell, mix):
    result, lines = _run(cell, mix=mix)
    assert result["correct"], lines
    assert result["attempted"] >= 4 and result["failed"] == 0
    assert set(result["metrics"]) == {
        m["name"] for m in hb_harness.metric_entries(
            hb_harness.load_json(ROOT / "BENCHMARK.json"), cell, False)}
    assert list(result)[-1] == "checks"
    assert [ln.split()[0] for ln in lines] == list(result["checks"])
    json.dumps(result, allow_nan=False)


def _half_batch(fn):
    """Half of the batch left out: the rest scored, their mean given to
    the half left out."""
    def broken(data):
        tok = np.asarray(data["tokens"])
        half = max(1, len(tok) // 2)
        out = np.asarray(fn({"tokens": tok[:half]}))
        return np.concatenate([out, np.full(len(tok) - half, out.mean(),
                                            out.dtype)])
    return broken


def _answer_altered(fn):
    """One answer altered where it is produced: the first row's score
    flips its sign."""
    def broken(data):
        out = np.array(fn(data))
        out[0] = -out[0] - np.sign(out[0])
        return out
    return broken


@pytest.mark.parametrize("fault", [_half_batch, _answer_altered],
                         ids=["half_batch", "answer_altered"])
def test_broken_udf_is_not_correct(fault):
    result, lines = _run("smollm-135m.long", udf_hook=fault)
    assert not result["correct"], lines


def test_row_left_out_of_the_scan_is_not_correct(monkeypatch):
    """A row dropped from each query's scan reaches no score and no
    answer."""
    from repro_torch.core import plan

    inner = plan.batches_of

    def dropping(q):
        it = inner(q)
        first = next(it)
        yield plan.make_batch({k: v[1:] for k, v in first.data.items()},
                              first.row_ids[1:])
        yield from it

    monkeypatch.setattr(plan, "batches_of", dropping)
    result, lines = _run("smollm-135m.long")
    assert not result["correct"], lines
    assert result["checks"]["rows_wrong"]["value"] > 0


def test_run_reports_what_the_host_did():
    """The result's ``host`` key: the process's CPU seconds over the
    window (the allocator's reserved peak is read on a card only)."""
    result, _ = _run("smollm-135m.long", seconds=0.5)
    assert result["host"]["process_cpu_s"] > 0
    assert list(result)[-2:] == ["host", "checks"]


def test_trace_reduction():
    """Busy time is the union of the device's spans inside the window;
    idle time is named by what the host was doing."""
    events = [("k1", 1.0, 0.5), ("k2", 1.25, 0.5), ("flash", 3.0, 1.0),
              ("early", 0.0, 0.5)]
    calls = [(2.0, 2.5, 64, 64 * 512, 1000)]
    queries = [{"submitted": 0.9, "started": 1.0, "done": 4.4}]
    s = hb_harness.summarize_trace(events, 1.0, 5.0, calls, queries)
    assert s.busy_s == pytest.approx(1.75)
    assert s.window_s == pytest.approx(4.0)
    assert s.by_name == {"k1": 0.5, "k2": 0.5, "flash": 1.0}
    assert s.idle_by_host == pytest.approx({"udf_call": 1.25,
                                            "client": 1.0})


def test_metric_readers():
    bench = hb_harness.load_json(ROOT / "BENCHMARK.json")
    cell = hb_harness.load_cell("smollm-135m.long", True)
    queries = [{"rows": 100, "state": "DONE", "submitted": 0.0,
                "done": 1.0 + i, "queue_s": 0.5, "started": 0.5}
               for i in range(10)]
    calls = [(0.0, 0.1, 64, 64 * 512, 64 * 448)] * 3
    evals = [([b""] * 64, np.zeros(64), np.full(64, 448))]
    trace = hb_harness.TraceSummary(busy_s=8.0, window_s=10.0,
                                    by_name={"flash_shared_kernel": 0.01},
                                    idle_by_host={})
    run = hb_harness.Run(cell, 10.0, 5.0, 0.0, 10.0, queries, calls, evals,
                         trace)
    got = {n: r.read(run) for n, (_, r) in cell.metrics.items()}
    assert got["service_wait_ms.mean"] == pytest.approx(500.0)
    assert got["udf_call_rows.mean"] == 64
    assert got["udf_live_token_share"] == pytest.approx(87.5)
    assert got["udf_call_ms.mean"] == pytest.approx(100.0)
    assert got["device_idle"] == pytest.approx(20.0)
    flops = 64 * cell.family.row_flops(cell.cfg, 448)
    assert got["mfu"] == pytest.approx(100 * flops / 10.0 / 989e12)
    bound = 3 * 30 * 3.005e-5
    assert got["flash_fwd_roofline"] == pytest.approx(100 * bound / 0.01,
                                                      rel=1e-3)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    c0 = hb_harness.load_cell("smollm-135m.long", False)
    got0 = {n: r.read(run) for n, (_, r) in c0.metrics.items()}
    assert set(got0) == {n for n in e2e
                         if "smollm-135m.long" in e2e[n].get(
                             "workloads", ["smollm-135m.long"])}
    assert got0["rows_per_s"] == pytest.approx(10 * 100 / 10.0)
    assert got0["query_s.p50"] == pytest.approx(5.5)


@pytest.mark.gpu
def test_command_on_the_card():
    """The command itself, for a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "hydrobench/run.py", "--workload",
         "smollm-135m.long", "--seed", str(SEED), "--seconds", "5",
         "--trace", "1"], capture_output=True, text=True, cwd=ROOT,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-2000:]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
