"""The card self timeline of the metrics and the results' export
(``mfcd.metrics`` + ``mfcd.export`` + ``mfcd.sweep.collect`` +
``mfcd.sweep.export``) over the window's calls, ms a run (the program's
own records, taken with no profiler)."""

from portbench import stages

NAMES = ("mfcd.metrics", "mfcd.export", "mfcd.sweep.collect",
         "mfcd.sweep.export")


def read(summary, ctx):
    return stages.card_ms_per_run(stages.program_log(), ctx, NAMES)
