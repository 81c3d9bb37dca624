"""The device's idle share of the traced window, in percent: 1 - the
union of kernel, copy and set intervals over the window's length."""


def read(ctx):
    if ctx["window_s"] <= 0 or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
