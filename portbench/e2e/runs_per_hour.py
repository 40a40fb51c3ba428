"""Training runs completed in the window x 3600 / the window's seconds
(host clock; a call ends with its results on the host)."""


def read(window, ctx):
    return window.runs * 3600.0 / window.seconds
