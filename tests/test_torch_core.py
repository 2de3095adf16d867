"""The port's framework-free core against the JAX package's.

* ``repro_torch`` imports neither JAX nor ``repro`` (checked in a fresh
  interpreter, and on the source lines);
* every core module is the reference's with only its imports rewritten;
* a SimClock scenario of planted predicates in the style of
  benchmarks/bench_uc1_synthetic.py, with seeded statistics, gives
  bit-identical makespans, per-predicate statistics and row-id sets
  through both packages under every eddy policy.
"""
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import torch
import pytest

import repro.core as jax_core
import repro.udfs.synthetic as jax_synthetic
import repro_torch
import repro_torch.core as port_core
import repro_torch.udfs.synthetic as port_synthetic
from repro.core.policies import EDDY_POLICIES

# small tensors: one intra-op thread, so these tests do not crowd the
# timing-sensitive executor tests running beside them
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
CORE_MODULES = sorted(
    f for f in os.listdir(os.path.join(SRC, "repro", "core"))
    if f.endswith(".py") and f != "vectorized.py"
)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              prefix="repro_torch.")
    )


def test_port_imports_neither_jax_nor_repro():
    mods = _port_modules()
    assert "repro_torch.core.executor" in mods
    assert "repro_torch.examples.lost_dog_query" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_import_line_names_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    offenders = [
        f"{path}:{i}" for path in files
        for i, line in enumerate(open(path), 1) if pattern.match(line)
    ]
    assert not offenders, offenders


@pytest.mark.parametrize("module", CORE_MODULES)
def test_core_module_is_the_reference_with_imports_rewritten(module):
    ref = open(os.path.join(SRC, "repro", "core", module)).read()
    port = open(os.path.join(SRC, "repro_torch", "core", module)).read()
    rewritten = re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.",
                       ref, flags=re.M)
    assert port == rewritten


# --------------------------------------------------------------------------- #
# SimClock parity                                                             #
# --------------------------------------------------------------------------- #
COST_A, COST_B = 0.010, 0.020
N_ROWS = 200
SELECTIVITIES = [(0.3, 0.1), (0.7, 0.5), (0.5, 0.9)]


def _scenario(core, synthetic, policy, sel_a, sel_b, seed=0):
    rng = np.random.default_rng(seed)
    a_pass = rng.choice(N_ROWS, int(N_ROWS * sel_a), replace=False)
    b_pass = rng.choice(N_ROWS, int(N_ROWS * sel_b), replace=False)
    A = synthetic.planted_predicate("A", a_pass, cost_per_row=COST_A,
                                    resource="cpu")
    B = synthetic.planted_predicate("B", b_pass, cost_per_row=COST_B,
                                    resource="accel:0")
    batches = [
        core.make_batch({"rid": np.arange(i, i + 10)}, np.arange(i, i + 10))
        for i in range(0, N_ROWS, 10)
    ]
    ex = core.AQPExecutor([A, B], policy=core.policies.EDDY_POLICIES[policy](),
                          clock=core.SimClock(), max_workers=1, warmup=False)
    # statistics seeded with the true cost and selectivity, as in
    # tests/test_policies.py: learned from scratch, the reference's own
    # timeline depends on thread timing and differs from run to run
    for name, cost, sel in (("A", COST_A, sel_a), ("B", COST_B, sel_b)):
        st = ex.stats[name]
        st.cost_per_row.update(cost)
        st.tickets = 1000
        st.wins = int(1000 * (1 - sel))
        st.batches = 1
    got = sorted(int(i) for b in ex.run(iter(batches)) for i in b.row_ids)
    snap = ex.stats_snapshot()
    return {
        "makespan": ex.makespan,
        "rows": got,
        "expected": sorted(set(a_pass.tolist()) & set(b_pass.tolist())),
        "stats": {p: snap[p] for p in ("A", "B")},
    }


@pytest.mark.parametrize("policy", sorted(EDDY_POLICIES))
def test_simclock_timeline_is_bit_identical(policy):
    for sel_a, sel_b in SELECTIVITIES:
        ref = _scenario(jax_core, jax_synthetic, policy, sel_a, sel_b)
        port = _scenario(port_core, port_synthetic, policy, sel_a, sel_b)
        assert ref["rows"] == ref["expected"]
        assert port == ref
