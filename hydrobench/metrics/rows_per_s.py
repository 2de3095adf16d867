"""rows_per_s: table rows of every query submitted in the window and
answered, over the seconds from the window's start to the last answer.
The queries in flight at the close are awaited and counted, with the time
they take: a query's rows never fall on either side of the close, so the
rate holds all the work and all the time it took."""


def read(run):
    done = [q for q in run.queries if q["state"] == "DONE"]
    if not done:
        return None
    end = max(q["done"] for q in run.queries)
    return sum(q["rows"] for q in done) / (end - run.t0)
