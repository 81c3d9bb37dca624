"""Milliseconds of one primal-dual iteration: the spans of the PD
solves (each ending in a synchronise) over the iterations they return."""


def read(ctx):
    sp = ctx["spans"]
    n = sp.counts.get("pd_iters", 0)
    if not sp.seconds.get("pd") or not n:
        return None
    return 1e3 * sum(sp.seconds["pd"]) / n
