"""Milliseconds a major cycle spends outside the PD solve and the
exact-residual application: the window's whole time less those spans,
over the majors finished (the worker's host numpy, the power method,
plans, wavelet set-up and the data step)."""


def read(ctx):
    s = ctx["spans"].seconds
    if not ctx["units"] or "pd" not in s:
        return None
    rest = ctx["window_s"] - sum(s["pd"]) - sum(s.get("vis_hessian", []))
    return 1e3 * rest / ctx["units"]
