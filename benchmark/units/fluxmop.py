"""One unit of the vis-space fluxmop traffic: a whole ``_fluxmop``
call with the exact Hessian (``use_psf=False``) from the dirty image:
the pg plans built twice, a PCG whose every iteration applies R.H W R
over all the visibilities, and the exact residual.

Set-up: the observation's columns, ``_init`` and ``_grid``
(harness/dataset.py), and one short call. Correctness: the first
finished call's residual against the plain reference
(reference/fluxmop.py) worked out again from the columns. The residual
and not the model: a PCG of 100 iterations on a system this
ill-conditioned leaves the update's weakly measured part to round-off
(PERF.md), while the residual it leaves is determined."""

from harness.dataset import gridded, observe  # noqa: F401


def setup(cfg, traffic, seed, device):
    from pfb_tpu_torch.workers.fluxmop import _fluxmop
    cols, dds = gridded(cfg, seed, device)
    kw = dict(backend=cfg["backend"], epsilon=cfg["epsilon"],
              **traffic["call"])
    _fluxmop(ddsi=dds, write=False, device=device, verbose=0,
             **dict(kw, **traffic["warmup"]))
    return dict(cols=cols, dds=dds, kw=kw, device=device)


def call(state):
    """(1, output) of one call."""
    from pfb_tpu_torch.workers.fluxmop import _fluxmop
    stats = {}
    model, residual = _fluxmop(ddsi=state["dds"], write=False,
                               device=state["device"], stats=stats,
                               verbose=0, **state["kw"])
    return 1, dict(model=model, residual=residual, stats=stats)


def probe(state):
    """Nothing to keep beyond the call's own answer."""
    return dict


def compare(out, ref):
    """The number that decides ``correct``: the residual's largest gap
    relative to the largest magnitude of the reference's dirty image."""
    import numpy as np
    return dict(resid_gap=float(np.abs(out["residual"] - ref["residual"])
                                .max() / ref["dirty_max"]))


def instrument(spans):
    """Spans around the fluxmop worker's constructions of the exact
    Hessian and each of their applications."""
    import pfb_tpu_torch.workers.fluxmop as w
    saved = w.make_hessian_dds
    w.make_hessian_dds = spans.wrap_maker(saved, "plan", "vis_hessian")

    def undo():
        w.make_hessian_dds = saved
    return undo


def reference(obs, cfg, traffic, control=False):
    from reference.fluxmop import fluxmop
    from reference.spotless import CONTROL, REFERENCE
    c = traffic["call"]
    return fluxmop(obs, sigmainv=c["sigmainv"], gamma=c["gamma"],
                   cg_tol=c["cg_tol"], cg_maxit=c["cg_maxit"],
                   cg_minit=c["cg_minit"],
                   num=CONTROL if control else REFERENCE)


def check(inputs, out, cfg, traffic, device):
    return compare(out, reference(observe(inputs, cfg, device), cfg,
                                  traffic))


def diagnose(out, ref):
    import numpy as np
    m = ref["model"]
    return dict(cg_iters=ref["cg_iters"],
                model_gap=float(np.linalg.norm(out["model"] - m) /
                                np.linalg.norm(m)),
                model_max=[float(abs(out["model"]).max()),
                           float(abs(ref["model"]).max())])
