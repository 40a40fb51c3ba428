"""The 95th percentile of the wall time of every call in the window
(host clock, from the call to its results on the host)."""

from portbench.workload import percentile


def read(window, ctx):
    return percentile([c.wall for c in window.calls], 95)
