"""udf_live_token_share: live tokens (id > 0) over the token slots handed
to the UDF's ``fn`` (rows times the padded length, bucket padding
included), in %."""


def read(run):
    slots = sum(c[3] for c in run.calls)
    return 100.0 * sum(c[4] for c in run.calls) / slots if slots else None
