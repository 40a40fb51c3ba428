"""The whole run's share of the card's float32 peak, in percent: K1's
counted operations for every epoch of every training run the (untraced)
window completed, over the window's seconds x 67 TFLOP/s."""

from portbench import roofline


def read(summary, ctx):
    window = ctx["window"]
    st = ctx["cell"].config["study"]
    n, m, d, bs = st["n"], st["m"], st["d"], st["batch_size"]
    count, _ = roofline.study_stream(st)
    steps = roofline.epoch_steps(count, bs) * st["num_epochs"]
    if not window.runs:
        return None
    flops = roofline.k1_flops(steps, n, m, d, bs) * window.runs
    return 100.0 * flops / (window.seconds * roofline.PEAK_F32_FLOPS)
