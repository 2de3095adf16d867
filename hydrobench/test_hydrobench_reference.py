"""The frozen reference against the port's CPU path, its fp8 control, and
the counts."""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

import hb_counts  # noqa: E402
import hb_harness  # noqa: E402
import hb_reference  # noqa: E402

# reduced widths, float32: the port's CPU path runs the kernels' plain
# versions, so it and the reference agree to float32 rounding
SMALL = {
    "smollm-135m": {"hidden_size": 64, "intermediate_size": 128,
                    "num_attention_heads": 4, "num_key_value_heads": 2,
                    "num_hidden_layers": 2, "vocab_size": 512, "head_dim": 16,
                    "embedding_rows": 512, "torch_dtype": "float32"},
    "mamba2-370m": {"d_model": 64, "n_layer": 2, "headdim": 16, "d_state": 16,
                    "vocab_size": 500, "embedding_rows": 512,
                    "torch_dtype": "float32"},
}
# the published widths at two layers: the control's test
TWO_LAYERS = {"smollm-135m": {"num_hidden_layers": 2, "torch_dtype": "float32"},
              "mamba2-370m": {"n_layer": 2, "torch_dtype": "float32"}}


def _cell(config, over):
    return hb_harness.load_cell(f"{config}.long", False,
                                overrides={"cfg": over[config]})


def _tokens(n_rows, width, seed):
    rng = np.random.default_rng(seed)
    tok = np.zeros((n_rows, width), np.int32)
    for i in range(n_rows):
        n = int(rng.integers(width // 4, width + 1))
        tok[i, :n] = rng.integers(10, 256, size=n)
    return tok


def _port_and_reference(cell, tok, seed=3):
    pcfg = hb_harness.port_config(cell.cfg)
    gen = torch.Generator("cpu").manual_seed(seed)
    weights = cell.family.make_weights(cell.cfg, gen, "cpu",
                                       getattr(torch, pcfg.dtype))
    params = hb_harness.port_params(pcfg, weights, "cpu")
    got = cell.udf.build(pcfg, params, "cpu").fn({"tokens": tok})
    rows = [torch.from_numpy(r[:np.count_nonzero(r)].astype(np.int64))
            for r in tok]
    ref = hb_reference.scores(cell.family, cell.cfg, weights, rows)
    low = hb_reference.scores(cell.family, cell.cfg, weights, rows, "fp8")
    n = np.count_nonzero(tok, axis=1)
    gap = np.abs(np.asarray(got, np.float64) - ref) / n
    return gap, np.abs(np.asarray(low) - ref) / n


@pytest.mark.parametrize("config", sorted(SMALL))
def test_reference_agrees_with_port_cpu_path(config):
    cell = _cell(config, SMALL)
    gap, _ = _port_and_reference(cell, _tokens(6, 128, 1))
    assert gap.max() < 1e-5, gap


@pytest.mark.parametrize("config", sorted(TWO_LAYERS))
def test_control_departs_from_reference(config):
    """At the published widths (two layers), the fp8 control lies far
    further from the reference than the port's float32 path does."""
    cell = _cell(config, TWO_LAYERS)
    gap, control = _port_and_reference(cell, _tokens(3, 64, 2))
    assert control.max() > 100 * max(gap.max(), 1e-7), (gap, control)


def test_control_is_judged_by_the_run_check():
    """The control's answers go through the run's own check: at a small
    size on the CPU, against a limit at the float32 path's agreement
    (1e-5), the fp8 control reads not correct, and its numbers are the
    check's."""
    import hb_control

    cell = hb_harness.load_cell("smollm-135m.long", False, overrides={
        "cfg": SMALL["smollm-135m"],
        "traffic": {"rows_per_query": {"median": 40, "sigma": 0.5, "min": 16,
                                       "max": 120, "deck": 8, "strata": 4}}})
    cell.spec["check"] = {"sample_rows": 12, "limits": {
        "score_gap": 1e-5, "rows_wrong": 0, "queries_failed": 0}}
    got = hb_control.control(cell, 2**31 + 5, "cpu")
    assert got["correct"] is False, got
    assert list(got["checks"]) == ["score_gap", "rows_wrong",
                                   "queries_failed"]
    assert got["checks"]["score_gap"]["value"] > 1e-5
    assert got["checks"]["queries_failed"]["value"] == 0


def test_mamba2_head_is_the_embeddings_transpose():
    """The published mamba2-370m ties its head to its embedding: the
    benchmark makes the head the embedding's transpose, by value."""
    cell = _cell("mamba2-370m", SMALL)
    w = cell.family.make_weights(cell.cfg, torch.Generator().manual_seed(4),
                                 "cpu", torch.float32)
    assert torch.equal(w["out_head"], w["embed"].t())
    assert cell.cfg["tie_embeddings"] and not cell.cfg["reduced"]


def test_fp8_round():
    x = torch.tensor([[1.0, -3.0, 0.1, 448.0]])
    y = hb_reference.fp8_round(x, -1)
    assert torch.equal(y[0, 3], x[0, 3])
    assert 0 < (y - x).abs().max() < 0.1 * x.abs().max()


def test_ssd_flops_counts_the_chunked_scan():
    """The count agrees with the port's own count where the length is a
    whole number of chunks, and the last chunk's triangle is counted
    short."""
    from repro_torch.kernels import ssd

    assert hb_counts.ssd_flops(4, 512, 32, 64, 128, 64) == \
        ssd.flops(4, 512, 32, 64, 128, 64)
    assert hb_counts.ssd_flops(1, 65, 1, 2, 3, 64) == \
        hb_counts.ssd_flops(1, 64, 1, 2, 3, 64) \
        + 2 * (2 * 1 * 2 * 3 + 1 * (2 + 3))


@pytest.mark.parametrize("config", ["smollm-135m", "mamba2-370m"])
def test_row_flops_against_parameters(config):
    """Per token the model's products are twice its layers' matrices and
    its head, plus the mixer's part over the tokens before it."""
    cell = hb_harness.load_cell(f"{config}.long", False)
    shapes = cell.family.weight_shapes(cell.cfg)
    mats = sum(math.prod(s) for k, s in shapes.items()
               if k.startswith("layers.w"))
    per_token = 2 * (mats + cell.cfg["vocab_size"] * shapes["embed"][1])
    f1 = cell.family.row_flops(cell.cfg, 1)
    assert per_token < f1 < per_token * 1.1


def test_flash_bound_at_the_llm_shape():
    """The LLM's 64-row attention call, (64, 512, 9, 3, 64): 0.0300 ms, by
    the bytes."""
    b = hb_counts.flash_fwd_bound_s(64, 512, 9, 3, 64)
    assert abs(b - 3.005e-5) < 1e-7


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["smollm-135m.long", "mamba2-370m.long"])
def test_control_fails_the_limit_on_the_card(cell):
    """The control at the cell's own size fails the cell's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(HERE / "hb_control.py"), "--workload", cell,
         "--seeds", "91"], capture_output=True, text=True, cwd=ROOT,
        timeout=900, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is False, got
