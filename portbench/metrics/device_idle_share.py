"""1 - the union of the device operations' intervals / the traced wall,
in percent (device trace); ``device_idle_share.oracle`` reads the same
in the oracle's cell."""


def read(summary, ctx):
    if summary.window_s <= 0 or summary.launches == 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
