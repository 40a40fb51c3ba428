"""K1's least time over its device time, in percent, over the traced
calls of a cell whose calls change d and p (cell 13's p x d).

The least time is K1's operations at the float32 peak, the operations
counted from the traced calls' own ``k1.run_steps`` and
``k1.adam_elements`` (``k1_counts.flops``).  Every launch of such a cell
is bound by its operations: by ``roofline.k1_bytes``, at n = m = 1000 and
bs = 64, a launch of 5 runs needs about 8x more time for its operations
than for its bytes at d = 2, p = 0.1, and about 50x at d = 10, p = 1.0
(152 us against ~3 us), so the bound needs no bytes.  A program without
the counters reads None."""

from portbench import k1_counts, roofline, stages

NAME = "epoch_kernel<"


def read(summary, ctx):
    secs = sum(dev_s for name, (_, dev_s) in summary.by_name.items()
               if NAME in name)
    if secs <= 0:
        return None
    ops = k1_counts.flops(stages.traced_records(stages.program_log(), ctx),
                          ctx["cell"].config["study"])
    if ops is None:
        return None
    return 100.0 * ops / roofline.PEAK_F32_FLOPS / secs
