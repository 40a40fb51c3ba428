"""The whole run's share of the card's float32 peak, in percent, in a cell
whose calls change d and p: K1's operations in the (untraced) window's
calls, counted from their records' ``k1.run_steps`` and
``k1.adam_elements`` (``k1_counts.flops``), over the window's seconds x
67 TFLOP/s.  A program without the counters reads None."""

from portbench import k1_counts, roofline, stages


def read(summary, ctx):
    window = ctx["window"]
    ops = k1_counts.flops(stages.window_records(stages.program_log(), ctx),
                          ctx["cell"].config["study"])
    if ops is None or window.seconds <= 0:
        return None
    return 100.0 * ops / (window.seconds * roofline.PEAK_F32_FLOPS)
