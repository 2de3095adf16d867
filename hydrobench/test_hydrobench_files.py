"""The benchmark's files: BENCHMARK.json against its required form, each
cell's, configuration's, traffic's, UDF's and metric's file found by name,
no import of JAX or the JAX package, and a cell, configuration, traffic
mix and metric added as new files alone."""
from __future__ import annotations

import ast
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

import hb_harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hydrobench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert (ROOT / BENCH["command"][1]).is_file()


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    texts = [entry[k] for k in ("why", "layer") if k in entry]
    if "file" in entry:   # a configuration's source is a URL or paper
        texts.append(entry["source"])
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_loads(cell, trace):
    c = hb_harness.load_cell(cell, trace)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.spec["config"] == entry["config"]
    assert c.spec["traffic"] == entry["traffic"]
    assert c.cfg["name"] == entry["config"]
    assert all(callable(getattr(m, "read")) for _, m in c.metrics.values())
    assert callable(c.udf.build) and c.udf.NAME
    for fn in ("make_weights", "forward", "row_flops", "weight_shapes"):
        assert callable(getattr(c.family, fn))
    names = set(c.metrics)
    if not trace:
        assert "setup_s" in names and len(names) >= 2
    else:
        assert names


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    path = ROOT / entry["file"]
    assert path.is_relative_to(HERE)
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    # no width may be among the keys changed from the source
    widths = ("hidden", "intermediate", "d_model", "_dim", "_rank", "state",
              "expand", "head", "experts_per_tok")
    assert not [k for k in entry["reduced"] if any(w in k for w in widths)]
    assert (HERE / "families" / f"{cfg['family']}.py").is_file()
    assert (HERE / "udfs" / f"{cfg['udf']}.py").is_file()


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_moves_reported_where_read(metric):
    """Each per-layer metric moves an end-to-end metric that every cell
    reading it reports."""
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        e2e = {m["name"] for m in hb_harness.metric_entries(BENCH, cell,
                                                            False)}
        assert metric["moves"] in e2e


def test_every_cell_reports_enough():
    sources = {m["name"]: m["source"] for m in BENCH["end_to_end"]}
    assert set(sources.values()) <= {"host_clock", "device_trace"}
    for cell in CELLS:
        e2e = [m["name"] for m in hb_harness.metric_entries(BENCH, cell,
                                                            False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert hb_harness.metric_entries(BENCH, cell, True)
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25


def test_files_named_from_name_characters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_jax_import(path):
    """No module of the benchmark imports JAX or the JAX package, by
    top-level name compared whole (``repro_torch`` is the port)."""
    names = {n.split(".")[0] for n in _imports(ast.parse(path.read_text()))}
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names


def test_reference_imports_nothing_of_the_program():
    for rel in ("hb_reference.py", "hb_counts.py", "families/dense.py",
                "families/ssm.py", "hb_traffic.py"):
        names = {n.split(".")[0] for n in _imports(
            ast.parse((HERE / rel).read_text()))}
        assert "repro_torch" not in names, rel


def test_new_cell_as_new_files(tmp_path):
    """A later change adds a cell, a configuration, a traffic mix and a
    metric by adding files and BENCHMARK.json entries only."""
    shutil.copytree(HERE, tmp_path / "hydrobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    here = tmp_path / "hydrobench"
    cfg = json.loads((here / "configs" / "smollm-135m.json").read_text())
    cfg.update(name="smollm-135m-copy")
    (here / "configs" / "smollm-135m-copy.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "long.json").read_text())
    traffic["clients"] = 2
    (here / "traffic" / "two.json").write_text(json.dumps(traffic))
    spec = json.loads((here / "workloads" / "smollm-135m.long.json")
                      .read_text())
    spec.update(config="smollm-135m-copy", traffic="two")
    (here / "workloads" / "smollm-135m-copy.two.json").write_text(
        json.dumps(spec))
    (here / "metrics" / "queries_answered.py").write_text(
        "def read(run):\n    return float(len(run.queries))\n")
    bench["configs"].append({"name": "smollm-135m-copy", "source": "x",
                             "file": "hydrobench/configs/smollm-135m-copy.json",
                             "reduced": [], "why": "a copy"})
    bench["workloads"].append({"name": "smollm-135m-copy.two",
                               "config": "smollm-135m-copy",
                               "traffic": "two", "chips": 1, "why": "a copy"})
    bench["per_layer"].append({"name": "queries_answered", "unit": "queries",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "service", "moves": "rows_per_s",
                               "workloads": ["smollm-135m-copy.two"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = hb_harness.load_cell("smollm-135m-copy.two", True, root=tmp_path)
    assert cell.traffic["clients"] == 2
    assert cell.cfg["name"] == "smollm-135m-copy"
    _, reader = cell.metrics["queries_answered"]
    assert reader.read(type("R", (), {"queries": [1, 2, 3]})()) == 3.0
