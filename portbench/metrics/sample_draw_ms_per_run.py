"""The card time of the sampler's draw (``mfcd.sample.draw``: proposals,
the PRP map or the first-occurrence winners, the splits, the top-up) over
the window's calls, ms a run (the program's own records, taken with no
profiler): a detail span inside ``mfcd.sample``'s self time."""

from portbench import details, stages

NAME = "mfcd.sample.draw"


def read(summary, ctx):
    return details.card_ms_per_run(stages.program_log(), ctx, NAME)
