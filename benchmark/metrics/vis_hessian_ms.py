"""Milliseconds of one application of the exact vis-space Hessian
(R.H W R over every band's visibilities, the pg gridder and its w-plane
transforms): the mean span of the matvecs that make_hessian_dds
returned, each ending in a synchronise."""


def read(ctx):
    s = ctx["spans"].seconds.get("vis_hessian")
    return 1e3 * sum(s) / len(s) if s else None
