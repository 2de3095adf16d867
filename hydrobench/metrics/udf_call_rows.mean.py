"""udf_call_rows.mean: rows a UDF call computes, the bucket's padding
included (the span around the UDF's ``fn``), averaged over the calls."""


def read(run):
    return (sum(c[2] for c in run.calls) / len(run.calls)
            if run.calls else None)
