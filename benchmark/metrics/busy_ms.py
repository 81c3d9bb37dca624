"""Milliseconds the device is busy for each unit of the window (a
spotless major, a fluxmop call): the union of kernel, copy and set
intervals over the units finished. Host-paced noise leaves it alone,
so it stands beside the end-to-end rate, whose bound that noise
widens."""


def read(ctx):
    if not ctx["units"] or ctx["busy_s"] <= 0:
        return None
    return 1e3 * ctx["busy_s"] / ctx["units"]
