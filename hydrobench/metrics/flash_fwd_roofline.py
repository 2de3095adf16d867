"""flash_fwd_roofline: the flash forward's least time at the shapes of its
calls (``hb_counts.flash_fwd_bound_s``: one call a layer of each UDF call,
at the call's rows and padded length) over its device time in the trace
(kernels whose name holds "flash"), in %. None where the trace holds
none."""

import hb_counts


def read(run):
    if run.trace is None:
        return None
    device = sum(s for n, s in run.trace.by_name.items() if "flash" in n)
    if device <= 0:
        return None
    cfg = run.cell.cfg
    bound = sum(cfg["num_hidden_layers"] * hb_counts.flash_fwd_bound_s(
        rows, slots // rows, cfg["num_attention_heads"],
        cfg["num_key_value_heads"], cfg["head_dim"])
        for _, _, rows, slots, _ in run.calls)
    return 100.0 * bound / device
