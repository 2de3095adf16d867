"""mfu: model FLOPs of the live tokens of every row the UDF evaluated
(bucket padding and padded slots left out; ``hb_counts``), over the traced
window's seconds, over the bf16 peak, in %. The whole step's share of the
chip, which bounds what any kernel's gain can show."""

import hb_counts


def read(run):
    if run.trace is None or not run.evals:
        return None
    flops = sum(run.cell.family.row_flops(run.cell.cfg, int(n))
                for _, _, live in run.evals for n in live)
    return 100.0 * flops / run.trace.window_s / hb_counts.PEAK_BF16_FLOPS
