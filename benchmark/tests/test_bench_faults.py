"""A whole run on the CPU at a small size (the harness's look for a card
skipped), sound and with the timed path broken underneath: ``correct``
comes out true, and false for each fault a cell can have. Every cell
runs on one card and exchanges nothing between cards, so the fault of
a missing exchange has no place to be planted here."""

import time

import pytest
import torch

from bench_helpers import SEED, small_parts
from harness import main


SPOT, MOP = "syn64_2k.spotless", "syn64_2k.fluxmop_vis"


def _parts(workload):
    p = small_parts(workload)
    if workload == MOP:
        p["traffic"] = dict(p["traffic"], call=dict(
            p["traffic"]["call"], cg_maxit=30, cg_minit=30))
    return p


def _correct(p):
    _, _, numbers = main.run_cell(p, SEED, 0.0, 0, torch.device("cpu"),
                                  time.perf_counter())
    return all(v <= lim for v, lim in numbers.values()), numbers


@pytest.mark.parametrize("workload", [SPOT, MOP])
def test_sound_run_is_correct(workload):
    ok, numbers = _correct(_parts(workload))
    assert ok, numbers


def _unchanged(monkeypatch, workload):
    if workload == MOP:
        import pfb_tpu_torch.workers.fluxmop as w
        monkeypatch.setattr(w, "pcg", lambda A, b, **kw: torch.zeros_like(b))
        return
    import pfb_tpu_torch.opt.primal_dual as pd

    def step(x, v, lam, psiH, psi, L, l1weight, grad, **kw):
        return x, v, l1weight, kw["maxit"]
    monkeypatch.setattr(pd, "primal_dual", step)


def _half_the_bands(monkeypatch, workload):
    import pfb_tpu_torch.workers.fluxmop as wm
    import pfb_tpu_torch.workers.spotless as ws
    w = wm if workload == MOP else ws
    make = w.make_hessian_dds

    def half(*a, **kw):
        h = make(*a, **kw)

        def matvec(x):
            out = h(x)
            nb = out.shape[0]
            out[nb // 2:] = 0.0
            return out * (nb / (nb // 2))
        return matvec
    monkeypatch.setattr(w, "make_hessian_dds", half)


def _altered(monkeypatch, workload):
    if workload == MOP:
        import pfb_tpu_torch.workers.fluxmop as w
        solve = w.pcg

        def pcg(*a, **kw):
            x = solve(*a, **kw).clone()
            x[0] *= 1.01
            return x
        monkeypatch.setattr(w, "pcg", pcg)
        return
    import pfb_tpu_torch.workers.spotless as w
    make = w.make_primal_dual_fused

    def altered(*a, **kw):
        solve = make(*a, **kw)

        def run(*b, **kb):
            x, v, l1w, k = solve(*b, **kb)
            x = x.clone()
            x[0] *= 1.01
            return x, v, l1w, k
        return run
    monkeypatch.setattr(w, "make_primal_dual_fused", altered)


@pytest.mark.parametrize("workload", [SPOT, MOP])
@pytest.mark.parametrize("fault", [_unchanged, _half_the_bands, _altered])
def test_fault_is_not_correct(monkeypatch, fault, workload):
    fault(monkeypatch, workload)
    ok, numbers = _correct(_parts(workload))
    assert not ok, numbers

