"""query_s.p90: the 90th percentile of the seconds from submit to answer
over every query submitted in the window (those in flight at its close
are awaited) and answered. Per-layer: a window's few tens of queries
leave too few beyond it for an end-to-end tail."""

import numpy as np


def read(run):
    lat = [q["done"] - q["submitted"] for q in run.queries
           if q["state"] == "DONE"]
    return float(np.quantile(lat, 0.9)) if lat else None
