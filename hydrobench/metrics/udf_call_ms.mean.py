"""udf_call_ms.mean: host ms a UDF call takes, from the call of ``fn`` to
its return after the copy back, averaged over the calls."""


def read(run):
    return (1e3 * sum(c[1] - c[0] for c in run.calls) / len(run.calls)
            if run.calls else None)
