"""The card self timeline of generation, sampling and labelling
(``mfcd.generate`` + ``mfcd.sample`` + ``mfcd.label``) over the window's
calls, ms a run (the program's own records, taken with no profiler)."""

from portbench import stages

NAMES = ("mfcd.generate", "mfcd.sample", "mfcd.label")


def read(summary, ctx):
    return stages.card_ms_per_run(stages.program_log(), ctx, NAMES)
