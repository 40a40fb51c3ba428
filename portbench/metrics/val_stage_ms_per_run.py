"""The card self timeline of the validation pass (``mfcd.train.val``)
over the window's calls, ms a run: with the host's issue and waits, which
``val_ms_per_run``'s kernel time leaves out (the program's own records,
taken with no profiler)."""

from portbench import stages

NAMES = ("mfcd.train.val",)


def read(summary, ctx):
    return stages.card_ms_per_run(stages.program_log(), ctx, NAMES)
