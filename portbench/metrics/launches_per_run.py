"""Kernel launches in the traced calls / runs they completed (device
trace): the sweep engine's count, and as ``launches_per_run.oracle`` the
ground-truth oracle's."""


def read(summary, ctx):
    traced = ctx["traced"]
    if not traced or not traced["runs"] or not summary.launches:
        return None
    return summary.launches / traced["runs"]
