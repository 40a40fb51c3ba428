"""The card time of the sampler's tables (``mfcd.sample.tables``: the
top-k tables, the SVD's top sets, the margin window, the CDFs) over the
window's calls, ms a run (the program's own records, taken with no
profiler): a detail span inside ``mfcd.sample``'s self time."""

from portbench import details, stages

NAME = "mfcd.sample.tables"


def read(summary, ctx):
    return details.card_ms_per_run(stages.program_log(), ctx, NAME)
