"""The harness: one run of one cell.

Everything that belongs to one configuration, traffic mix, UDF or metric
lives in a file of its own that this module finds by name:

- ``workloads/<cell>.json``: the cell's configuration, traffic, query and
  service settings, and the limits its correctness check holds it to;
- ``configs/<config>.json``: the published sizes, how the program's
  configuration is made from them, and the UDF; ``families/<family>.py``
  the weights the benchmark makes and the plain reference;
- ``traffic/<mix>.json``: the parameters ``hb_traffic`` draws queries
  from;
- ``udfs/<udf>.py``: ``NAME`` and ``build(cfg, params, device)``;
- ``metrics/<metric>.py``: ``read(run)``, the metric's value or None.

A run: make the weights on the device from the seed, hand them to the
program, build the UDF, start the ``QueryService``, warm up the cell's
shapes (set-up ends here), let the closed-loop clients submit queries for
the window, wait for the queries in flight, then read the metrics, free
the program and hold a sample of the answers to the plain reference.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import threading
import time
from pathlib import Path

import numpy as np
import torch

import hb_reference
from hb_traffic import Traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GRACE_S = 60.0   # how long past the window's close an answer is awaited


# --------------------------------------------------------------------------- #
# finding a cell's parts by name                                               #
# --------------------------------------------------------------------------- #
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    name = "hb_" + "".join(c if c.isalnum() else "_"
                           for c in "/".join(path.parts[-2:]))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    spec: dict          # workloads/<cell>.json
    cfg: dict           # configs/<config>.json
    traffic: dict       # traffic/<mix>.json
    family: object      # families/<family>.py
    udf: object         # udfs/<udf>.py
    metrics: dict       # name -> (BENCHMARK.json entry, reader module)


def metric_entries(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with a trace its per-layer ones (an entry with ``workloads`` only in
    the cells it lists)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, trace: bool, *, root: Path = ROOT,
              overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json and its files.
    ``overrides`` replaces keys of the configuration ("cfg") and traffic
    ("traffic") files: the CPU tests run a cell at a small size."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    here = root / "hydrobench"
    spec = load_json(here / "workloads" / f"{name}.json")
    cfg = load_json(here / "configs" / f"{spec['config']}.json")
    traffic = load_json(here / "traffic" / f"{spec['traffic']}.json")
    overrides = overrides or {}
    cfg.update(overrides.get("cfg", {}))
    traffic.update(overrides.get("traffic", {}))
    metrics = {m["name"]: (m, load_module(here / "metrics" / f"{m['name']}.py"))
               for m in metric_entries(bench, name, trace)}
    return Cell(name, entry["chips"], spec, cfg, traffic,
                load_module(here / "families" / f"{cfg['family']}.py"),
                load_module(here / "udfs" / f"{cfg['udf']}.py"), metrics)


# --------------------------------------------------------------------------- #
# the program                                                                  #
# --------------------------------------------------------------------------- #
def port_config(cfg: dict):
    """The program's configuration: its own for ``port.arch``, with every
    field that the file maps replaced by the file's value."""
    from repro_torch.configs import get_config

    port = cfg["port"]
    return dataclasses.replace(
        get_config(port["arch"]),
        **{field: cfg[key] for field, key in port["fields"].items()})


def port_params(pcfg, weights: dict, device):
    """The program's parameter module for ``pcfg``, each leaf copied from
    the benchmark's ``weights`` on the device (the loader
    ``repro_torch.convert.model_params`` uses; it takes host arrays)."""
    from repro_torch.models.params import set_param
    from repro_torch.models.registry import model_api

    model = model_api(pcfg).Model(pcfg, device=device)
    with torch.no_grad():
        for name, value in weights.items():
            set_param(model, name, value)
    return model


def row_key(row: np.ndarray) -> bytes:
    """A row's identity by content: its live tokens (ids > 0; padding
    follows them)."""
    live = row[: int(np.count_nonzero(row))]
    return hashlib.blake2b(np.ascontiguousarray(live, np.int32).tobytes(),
                           digest_size=16).digest()


class Recorder:
    """Spans and counts taken around the calls into the UDF layer, and the
    scores the timed path produced (kept for the check)."""

    def __init__(self):
        self.calls = []    # (t0, t1, rows, slots, live tokens): UDF.fn
        self.evals = []    # (keys, scores, live per row): Predicate level

    def clear(self):
        self.calls, self.evals = [], []

    def wrap_fn(self, fn):
        def traced(data):
            t0 = time.monotonic()
            out = fn(data)
            t1 = time.monotonic()
            tok = np.asarray(data["tokens"])
            self.calls.append((t0, t1, tok.shape[0], tok.size,
                               int(np.count_nonzero(tok))))
            return out
        return traced

    def evaluated(self, tokens, out) -> None:
        tok = np.asarray(tokens)
        self.evals.append(([row_key(r) for r in tok],
                           np.asarray(out, np.float64).copy(),
                           np.count_nonzero(tok, axis=1)))


def traced_predicate(name, udf, recorder: Recorder):
    """The program's ``Predicate`` (score > 0), recording what each
    evaluation returned to the executor."""
    from repro_torch.core.udf import Predicate

    class TracedPredicate(Predicate):
        def evaluate_outputs(self, data):
            out = super().evaluate_outputs(data)
            recorder.evaluated(data["tokens"], out)
            return out

    return TracedPredicate(name, udf, compare=lambda s: s > 0)


# --------------------------------------------------------------------------- #
# the device trace                                                             #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    by_name: dict        # device op name -> seconds
    idle_by_host: dict   # what the host was doing -> idle device seconds


def host_activity(t: float, calls: list, queries: list) -> str:
    """What the host was doing at monotonic time ``t``: in a UDF call, in
    a query's executor outside any UDF call, a query waiting in the
    service's queue, or no query in the service."""
    if any(c[0] <= t <= c[1] for c in calls):
        return "udf_call"
    if any(q["started"] is not None and q["started"] <= t <= q["done"]
           for q in queries):
        return "executor"
    if any(q["submitted"] <= t <= q["done"] for q in queries):
        return "service_queue"
    return "client"


def summarize_trace(events: list, t0: float, t1: float, calls: list,
                    queries: list) -> TraceSummary:
    """``events``: (name, start, seconds) of the device's work, start on
    the monotonic clock; the window [t0, t1]."""
    spans, by_name = [], {}
    for name, start, dur in events:
        a, b = max(start, t0), min(start + dur, t1)
        if b <= a:
            continue
        spans.append((a, b))
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    spans.sort()
    busy, idle = 0.0, {}
    cursor = t0

    def gap(a, b):
        if b > a:
            what = host_activity((a + b) / 2, calls, queries)
            idle[what] = idle.get(what, 0.0) + (b - a)

    for a, b in spans:
        if b <= cursor:
            continue
        gap(cursor, a)
        busy += b - max(a, cursor)
        cursor = b
    gap(cursor, t1)
    return TraceSummary(busy, t1 - t0, by_name, idle)


def device_events(prof) -> list:
    """The device's kernels, copies and sets of a ``torch.profiler`` trace,
    as (name, monotonic start, seconds)."""
    from torch.autograd import DeviceType

    offset = time.time_ns() - time.monotonic_ns()   # kineto: wall clock
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out.append((e.name(), (e.start_ns() - offset) / 1e9,
                        e.duration_ns() / 1e9))
    return out


# --------------------------------------------------------------------------- #
# a run                                                                        #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Run:
    """What metric readers read."""
    cell: Cell
    seconds: float
    setup_s: float
    t0: float
    t_end: float
    queries: list        # dicts, one a query submitted in the window
    calls: list          # Recorder.calls
    evals: list          # Recorder.evals
    trace: TraceSummary | None


def host_reading(cpu0: float, dev) -> dict:
    """What the run's process did over the window: its CPU seconds (all
    its threads) and the allocator's reserved peak, the readings that
    tell the noise of a host-bound run."""
    out = {"process_cpu_s": time.process_time() - cpu0}
    if dev.type == "cuda":
        out["memory_reserved_peak_bytes"] = int(
            torch.cuda.max_memory_reserved(dev))
    return out


def _warm_tokens(rows: int, width: int) -> np.ndarray:
    tok = np.zeros((rows, width), np.int32)
    tok[:, :width - 1] = 10 + np.arange(width - 1) % 246
    return tok


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             udf_hook=None) -> tuple:
    """One run. Returns (result dict, check lines). ``udf_hook``, given,
    replaces the built UDF's ``fn`` by ``udf_hook(fn)``: the tests break
    the timed path with it."""
    from repro_torch.core.plan import Query, TrivialPredicate, batches_of
    from repro_torch.core.policies import EDDY_POLICIES, LAMINAR_POLICIES
    from repro_torch.core.resources import DevicePool
    from repro_torch.core.udf import bucket_rows
    from repro_torch.launch.serve import MAX_LEN, QueryService, review_source

    t_start = time.monotonic() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    spec, cfg = cell.spec, cell.cfg
    qspec = spec["query"]
    traffic = Traffic(cell.traffic, seed)

    # set-up: weights from the seed, on the device, in the served type
    pcfg = port_config(cfg)
    gen = torch.Generator(dev).manual_seed(int(seed) % (1 << 63))
    weights = cell.family.make_weights(cfg, gen, dev, getattr(torch,
                                                              pcfg.dtype))
    params = port_params(pcfg, weights, dev)
    udf = cell.udf.build(pcfg, params, dev)
    recorder = Recorder()
    fn = udf.fn if udf_hook is None else udf_hook(udf.fn)
    udf = dataclasses.replace(udf, fn=recorder.wrap_fn(fn))
    # one predicate name for every client: analysts running one
    # dashboard query (the service runs such queries one at a time)
    pred = traced_predicate(cell.udf.NAME, udf, recorder)
    column, op, value = qspec["trivial"]
    trivial = [TrivialPredicate(column, op, value)]
    service = QueryService(
        pool=DevicePool({udf.resource: int(cfg["udf_slots"])}),
        max_concurrent=int(spec["service"]["max_concurrent"]))

    def submit(rows):
        q = Query(source=review_source(rows), predicates=[pred],
                  trivial=trivial, batch_rows=qspec["batch_rows"])
        return service.submit(
            [pred], batches_of(q),
            policy=EDDY_POLICIES[qspec["policy"]](),
            laminar_policy_factory=LAMINAR_POLICIES[qspec["laminar_policy"]],
            max_workers=qspec["max_workers"])

    try:
        # warm-up: each bucket a call of up to batch_rows rows can take,
        # then one query through the service
        for b in sorted({bucket_rows(n) for n in
                         range(1, qspec["batch_rows"] + 1)}):
            udf.fn({"tokens": _warm_tokens(b, MAX_LEN)})
        submit(traffic.rows(0, stream=2)).result(timeout=600)
        if on_card:
            torch.cuda.synchronize()
        recorder.clear()
        setup_s = time.monotonic() - t_start

        # the window
        queries, lock = [], threading.Lock()
        nxt = [0]
        prof = None
        if trace and on_card:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        cpu0 = time.process_time()
        t0 = time.monotonic()
        t_end = t0 + seconds

        def client():
            while True:
                with lock:
                    if time.monotonic() >= t_end:
                        return
                    k = nxt[0]
                    nxt[0] += 1
                rows = traffic.rows(k)
                rec = {"k": k, "rows": len(rows), "state": "FAILED",
                       "ids": None, "queue_s": None, "started": None}
                rec["submitted"] = time.monotonic()
                try:
                    rep = submit(rows).result(
                        timeout=max(1.0, t_end + GRACE_S - time.monotonic()))
                    rec.update(state=rep.state, ids=rep.row_ids,
                               queue_s=rep.queue_time_s,
                               started=rec["submitted"] + rep.queue_time_s)
                except Exception as e:   # a query that fails or times out
                    rec["error"] = repr(e)
                rec["done"] = time.monotonic()
                with lock:
                    queries.append(rec)

        clients = [threading.Thread(target=client, name=f"hb-client-{i}",
                                    daemon=True)
                   for i in range(traffic.clients)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=seconds + GRACE_S + 30)
        t_drained = time.monotonic()
        summary = None
        if prof is not None:
            torch.cuda.synchronize()
            t_drained = time.monotonic()
            prof.__exit__(None, None, None)
            summary = summarize_trace(device_events(prof), t0, t_drained,
                                      recorder.calls, queries)
        memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        host = host_reading(cpu0, dev)
    finally:
        service.close(timeout=GRACE_S)

    queries.sort(key=lambda q: q["k"])
    run = Run(cell, seconds, setup_s, t0, t_end, queries, recorder.calls,
              recorder.evals, summary)
    metrics = {}
    for name, (entry, reader) in cell.metrics.items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}

    # the check, with the program's state freed
    del params, udf, pred, service, fn
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = check(cell, traffic, queries, recorder.evals, weights, seed)
    failed = sum(q["state"] != "DONE" for q in queries)
    result = {
        "correct": is_correct(checks),
        "attempted": len(queries),
        "failed": failed,
        "metrics": metrics,
        "device": device_info(dev, memory_peak, summary),
    }
    if summary is not None:
        result["breakdown"] = {
            "device_ops": sorted(([n[:120], s] for n, s in
                                  summary.by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([n, s] for n, s in
                                 summary.idle_by_host.items()),
                                key=lambda x: -x[1])[:10],
        }
    result["host"] = host
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    lines = [f"{k} {v!r} limit {lim!r}" for k, (v, lim) in checks.items()]
    return result, lines


def device_info(dev, memory_peak: int, summary) -> dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    return info


# --------------------------------------------------------------------------- #
# the check                                                                    #
# --------------------------------------------------------------------------- #
def sample_queries(traffic: Traffic, queries: list, want_rows: int,
                   seed: int, keep) -> list:
    """Queries answered in the run, drawn from the seed until their rows
    that reach the UDF number ``want_rows``, the largest query first."""
    done = [q for q in queries if q["state"] == "DONE"]
    if not done:
        return []
    order = list(np.random.default_rng([int(seed), 3]).permutation(len(done)))
    largest = max(range(len(done)), key=lambda i: done[i]["rows"])
    order.remove(largest)
    picked, rows = [], 0
    for i in [largest] + order:
        picked.append(done[i])
        rows += sum(keep(r) for r in traffic.rows(done[i]["k"]))
        if rows >= want_rows:
            break
    return picked


def is_correct(checks: dict) -> bool:
    """Every compared number within its limit."""
    return all(v <= lim for v, lim in checks.values())


def check(cell: Cell, traffic: Traffic, queries: list, evals: list,
          weights: dict, seed: int) -> dict:
    """The compared numbers, each (value, limit):

    - ``score_gap``: over the sampled queries' rows that reach the UDF,
      the widest gap between a score the timed path returned for the row
      and the reference's, over the row's live tokens (a mean logit gap);
    - ``rows_wrong``: rows of those queries that the answer has and the
      reference's lacks, or lacks and the reference's has, left out where
      the reference's score lies within ``score_gap``'s limit of zero;
      rows that reached no score; row ids given twice;
    - ``queries_failed``: queries of the window that failed or gave no
      answer within the grace after the window.

    ``hb_control`` calls it with the control's answers in the program's
    place."""
    limits = cell.spec["check"]["limits"]
    column, op, value = cell.spec["query"]["trivial"]
    if (column, op) != ("rating", "<="):
        raise ValueError("the check knows the rating <= filter only")

    def keep(r):
        return r.rating <= value

    sample = sample_queries(traffic, queries, cell.spec["check"]["sample_rows"],
                            seed, keep)
    scored = {}
    for keys, out, _ in evals:
        for k, s in zip(keys, out):
            scored.setdefault(k, []).append(float(s))
    rows_of = {q["k"]: [r for r in traffic.rows(q["k"]) if keep(r)]
               for q in sample}
    uniq = {}
    for rows in rows_of.values():
        for r in rows:
            uniq.setdefault(row_key(r.tokens), r.tokens)
    keys = list(uniq)
    hb_reference.float32_products()
    ref = dict(zip(keys, hb_reference.scores(
        cell.family, cell.cfg, weights,
        [torch.from_numpy(np.asarray(uniq[k], np.int64)) for k in keys])))
    gap, wrong = 0.0, 0
    lim_gap = limits["score_gap"]
    for q in sample:
        want, ambiguous = set(), set()
        for r in rows_of[q["k"]]:
            key, n = row_key(r.tokens), len(r.tokens)
            s = ref[key]
            got = scored.get(key)
            if not got:
                wrong += 1
            else:
                gap = max(gap, max(abs(p - s) for p in got) / n)
            if abs(s) / n <= lim_gap:
                ambiguous.add(r.rid)
            elif s > 0:
                want.add(r.rid)
        ids = [int(i) for i in q["ids"]]
        wrong += len(ids) - len(set(ids))
        wrong += len((set(ids) ^ want) - ambiguous)
    # no answered query is a failure too: nothing could be compared
    failed = sum(q["state"] != "DONE" for q in queries) + (not sample)
    return {"score_gap": (gap, lim_gap),
            "rows_wrong": (wrong, limits["rows_wrong"]),
            "queries_failed": (failed, limits["queries_failed"])}
