"""Seconds from the start of the process to the opening of the window:
imports, CUDA start-up, the kernels' build or load, the warm-up calls."""


def read(window, ctx):
    return window.setup_s
