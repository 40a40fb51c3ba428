"""K1's least time over its device time, in percent, over the traced
calls.

K1 trains one epoch of every run of a chunk in one launch, and a call
makes one chunk or more (``parameter_scan_fast`` splits a grid by the
card's memory).  Both the operations and the bytes grow with the runs,
so the least time of all the launches is ``roofline.k1_bound_s`` over
the traced calls' runs, once an epoch."""

from portbench import roofline

NAME = "epoch_kernel<"


def read(summary, ctx):
    secs = sum(dev_s for name, (_, dev_s) in summary.by_name.items()
               if NAME in name)
    traced = ctx["traced"]
    if not traced or not traced["runs"] or secs <= 0:
        return None
    st = ctx["cell"].config["study"]
    n, m, d, bs = st["n"], st["m"], st["d"], st["batch_size"]
    count, word = roofline.study_stream(st)
    runs = traced["runs"]
    steps = runs * roofline.epoch_steps(count, bs)
    bound = roofline.k1_bound_s(runs, steps, n, m, d, bs, word)
    return 100.0 * bound * st["num_epochs"] / secs
