"""ssd_fwd_roofline: the SSD forward's least time at the shapes of its
calls (``hb_counts.ssd_fwd_bound_s``: one call a layer of each UDF call,
at the call's rows and padded length, chunks of min(64, length)) over the
device time of its launches in the trace (kernels whose name holds
"ssd_fwd_" or "ssd_kernel"), in %. None where the trace holds none."""

import hb_counts


def read(run):
    if run.trace is None:
        return None
    device = sum(s for n, s in run.trace.by_name.items()
                 if "ssd_fwd_" in n or "ssd_kernel" in n)
    if device <= 0:
        return None
    cfg = run.cell.cfg
    d_inner = cfg["expand"] * cfg["d_model"]
    bound = 0.0
    for _, _, rows, slots, _ in run.calls:
        s = slots // rows
        bound += cfg["n_layer"] * hb_counts.ssd_fwd_bound_s(
            rows, s, d_inner // cfg["headdim"], cfg["headdim"],
            cfg["d_state"], cfg["ngroups"], min(64, s))
    return 100.0 * bound / device
