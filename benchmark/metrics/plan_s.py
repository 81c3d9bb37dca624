"""Seconds of one construction of the exact Hessian's pg plans
(make_hessian_dds: the host plan builder and the copies to the card)."""


def read(ctx):
    s = ctx["spans"].seconds.get("plan")
    return sum(s) / len(s) if s else None
