"""Syncs (device-to-host waits that PyTorch's sync debug mode reports)
the program counted in the traced calls, a run they completed."""

from portbench import stages


def read(summary, ctx):
    return stages.syncs_per_run(stages.program_log(), ctx)
