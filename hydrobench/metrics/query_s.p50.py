"""query_s.p50: the median of the seconds from submit to answer over every
query submitted in the window (those in flight at its close are awaited)
and answered."""

import numpy as np


def read(run):
    lat = [q["done"] - q["submitted"] for q in run.queries
           if q["state"] == "DONE"]
    return float(np.quantile(lat, 0.5)) if lat else None
