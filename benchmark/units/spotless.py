"""One unit of the spotless traffic: a whole ``_spotless`` call from
the dirty image, as a user's call runs it (its power method, pg plans
and wavelet set-up included), on the datasets that set-up gridded.

Set-up: the observation's columns, ``_init`` and ``_grid``
(harness/dataset.py), and one short call that touches every shape the
timed calls use. Correctness: the first call's first major (its model
and that model's exact-Hessian image, kept as the worker hands them to
the exact residual) against the plain reference (reference/spotless.py)
worked out again from the columns. The first major and not the last:
from the second on, float32 round-off alone moves some skies' models by
1e-5 to 1e-4, and the rms each later major leaves moves as far under
round-off as under the TF32 control (PERF.md)."""

from harness.dataset import gridded, observe  # noqa: F401


def _imaging(cfg):
    return dict(engine=cfg["engine"], backend=cfg["backend"],
                epsilon=cfg["epsilon"], bases=cfg["bases"],
                nlevels=cfg["nlevels"])


def setup(cfg, traffic, seed, device):
    from pfb_tpu_torch.workers.spotless import _spotless
    cols, dds = gridded(cfg, seed, device)
    kw = dict(_imaging(cfg), **traffic["call"])
    _spotless(ddsi=dds, write=False, device=device, verbose=0,
              **dict(kw, **traffic["warmup"]))
    return dict(cols=cols, dds=dds, kw=kw, device=device)


def call(state):
    """(majors completed, output) of one call."""
    from pfb_tpu_torch.workers.spotless import _spotless
    stats = {}
    model, residual = _spotless(ddsi=state["dds"], write=False,
                                device=state["device"], stats=stats,
                                verbose=0, **state["kw"])
    return len(stats["rms"]), dict(model=model, residual=residual,
                                   stats=stats, rms=stats["rms"])


def probe(state):
    """Keep, from the call that follows, the first exact-residual
    application's input (the first major's model) and output, copied to
    the host as they come and widened to float64 there. Returns the
    function that undoes the wrapper and hands over what it kept."""
    import pfb_tpu_torch.workers.spotless as w
    saved = w.make_hessian_dds
    kept = {}

    def make(*a, **kw):
        h = saved(*a, **kw)

        def matvec(x):
            out = h(x)
            if "model1" not in kept:
                kept["model1"] = x.detach().cpu().numpy().astype("f8")
                kept["hess1"] = out.detach().cpu().numpy().astype("f8")
            return out
        return matvec

    w.make_hessian_dds = make

    def undo():
        w.make_hessian_dds = saved
        return kept
    return undo


def instrument(spans):
    """Wrap what the spotless worker looks up by module-level name;
    returns the function that undoes it."""
    import pfb_tpu_torch.workers.spotless as w

    def pd_iters(sp, out):
        sp.counts["pd_iters"] += int(out[3])

    def psf_work(sp, op):
        from harness.roofline import conv_work
        consts = getattr(op, "consts", None)
        if consts is not None:  # K1: H is the Hermitian half
            hr, hi = consts["hr"], consts["hi"]
            sp.notes["psf_counter"] = "K1"
            x = sp.notes["psf_shape"]
            sp.notes["psf_work"] = conv_work(
                x[0], x[1], x[2], 2 * x[1], 2 * x[2], hr.numel(),
                hi is not None)
        else:  # K11: the full complex H
            nb, NX, NY = sp.notes["psf_full"]
            x = sp.notes["psf_shape"]
            sp.notes["psf_counter"] = "K11"
            sp.notes["psf_work"] = conv_work(nb, x[1], x[2], NX, NY,
                                             nb * NX * NY, True)

    saved = {n: getattr(w, n) for n in (
        "make_hessian_dds", "make_primal_dual_fused",
        "primal_dual_hostloop", "make_psf_convolve_pallas")}

    def make_psf(psf, nx, ny, *a, **kw):
        spans.notes["psf_shape"] = (psf.shape[0], nx, ny)
        spans.notes["psf_full"] = tuple(psf.shape)
        op = saved["make_psf_convolve_pallas"](psf, nx, ny, *a, **kw)
        psf_work(spans, op)
        return op

    def make_pd(*a, **kw):
        return spans.wrap(saved["make_primal_dual_fused"](*a, **kw), "pd",
                          pd_iters)

    w.make_hessian_dds = spans.wrap_maker(saved["make_hessian_dds"],
                                          "plan", "vis_hessian")
    w.make_primal_dual_fused = make_pd
    w.primal_dual_hostloop = spans.wrap(saved["primal_dual_hostloop"],
                                        "pd", pd_iters)
    w.make_psf_convolve_pallas = make_psf

    def undo():
        for n, f in saved.items():
            setattr(w, n, f)
    return undo


def reference(obs, cfg, traffic, control=False):
    """The plain reference's model and residual (reference/spotless.py):
    in float64, or with ``control`` in the control's numerics (float32
    with TF32 operands)."""
    from reference.spotless import CONTROL, REFERENCE, spotless
    call = traffic["call"]
    return spotless(obs, niter=call["niter"], pd_maxit=call["pd_maxit"],
                    bases=tuple(cfg["bases"].split(",")),
                    nlevels=cfg["nlevels"],
                    num=CONTROL if control else REFERENCE)


def rms_gap(got, want):
    """The largest gap, over the majors, between two lists of the rms
    each major left, relative to ``want``'s; infinite where the two ran
    a different number of majors."""
    if not want or len(got) != len(want):
        return float("inf")
    return max(abs(g - w) / w for g, w in zip(got, want))


def compare(out, ref):
    """The first major's model's l2 gap relative to the reference's
    norm and its exact-Hessian image's largest gap relative to the
    largest magnitude of the reference's dirty image, which decide
    ``correct``; and ``rms_gap`` over every major, which readings.py
    reports and no limit holds, as it does not part the program from
    the control (PERF.md). A call that gave no first major reads
    infinite."""
    import numpy as np
    if "model1" not in out:
        return dict(model1_gap=np.inf, hess1_gap=np.inf, rms_gap=np.inf)
    m, h = ref["model1"], ref["hess1"]
    return dict(
        model1_gap=float(np.linalg.norm(out["model1"] - m) /
                         np.linalg.norm(m)),
        hess1_gap=float(np.abs(out["hess1"] - h).max() / ref["dirty_max"]),
        rms_gap=rms_gap(out["rms"], ref["rms"]))


def final_gaps(out, ref):
    """The last major's model and residual against the reference's (no
    limit: PERF.md gives their readings)."""
    from reference.spotless import compare as gaps
    return gaps(out["model"], out["residual"], ref)


def check(inputs, out, cfg, traffic, device):
    """The numbers that decide ``correct``: the first finished call
    against the reference."""
    return compare(out, reference(observe(inputs, cfg, device), cfg,
                                  traffic))


def diagnose(out, ref):
    """Side by side, what the two solves saw: the spectral norms, the
    rms after each major, the largest model pixel."""
    return dict(final=final_gaps(out, ref),
                hessnorm=[out["stats"]["hessnorm"], ref["hessnorm"]],
                rms=[out["stats"]["rms"], ref["rms"]],
                model_max=[float(abs(out["model"]).max()),
                           float(abs(ref["model"]).max())])


def look(dds, out, obs, ref, cfg, traffic, device):
    """Where the program and the reference part: the reference's solve
    in float32 (the solver's round-off alone), and the program's dirty
    image, PSF and exact Hessian (on the reference's model) against the
    reference's, each over the reference dirty image's largest
    magnitude."""
    import numpy as np
    import torch
    from pfb_tpu_torch.ops.gridder import make_hessian_dds
    from pfb_tpu_torch.workers.cubes import dds2cubes
    from reference.spotless import Numerics, spotless
    call = traffic["call"]
    r32 = spotless(obs, niter=call["niter"], pd_maxit=call["pd_maxit"],
                   bases=tuple(cfg["bases"].split(",")),
                   nlevels=cfg["nlevels"], num=Numerics(torch.float32))
    nb = obs.dirty.shape[0]
    dirty, _, _, psf, _, _, wsums, _ = dds2cubes(dds, nb)
    scale = ref["dirty_max"]
    h = make_hessian_dds(dds, nb, wsums.sum(), cfg["nx"], cfg["nx"],
                         use_beam=False, backend=cfg["backend"],
                         epsilon=cfg["epsilon"], device=device)
    m = torch.as_tensor(ref["model"], dtype=torch.float32, device=device)
    hp = h(m).double().cpu().numpy()
    hr = obs.hessian(torch.as_tensor(ref["model"], device=device))
    hr = hr.cpu().numpy()
    return dict(
        solve32=compare(r32, ref), solve32_final=final_gaps(r32, ref),
        dirty=float(np.abs(dirty - obs.dirty.cpu().numpy()).max() / scale),
        psf=float(np.abs(psf - obs.psf.cpu().numpy()).max()),
        hessian=float(np.abs(hp - hr).max() / scale))
