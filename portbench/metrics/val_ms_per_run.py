"""Device milliseconds of the kernels launched inside ``mfcd.train.val``
spans (launch containment) / training runs the traced calls completed."""

SPAN = "mfcd.train.val"


def read(summary, ctx):
    traced = ctx["traced"]
    secs = summary.by_span.get(SPAN)
    if not traced or not traced["runs"] or not secs:
        return None
    return secs * 1e3 / traced["runs"]
