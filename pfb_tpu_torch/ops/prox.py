"""Proximal operators for the l21 regularisers (counterpart of
pfb_tpu/ops/prox.py). v is (nband, nbasis, nymax, nxmax); weight is
(nbasis, nymax, nxmax)."""

import torch


def _safe_ratio(num, den, where_zero):
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.full_like(den, where_zero))


def prox_21(v, sigma, weight=1.0, axis=0):
    """prox of sigma*||.||_21 with the l2 norm over ``axis``."""
    l2_norm = torch.linalg.vector_norm(v, dim=axis)
    l2_soft = torch.clamp(l2_norm - sigma * weight, min=0.0)
    return v * _safe_ratio(l2_soft, l2_norm, 0.0).unsqueeze(axis)


def prox_21m(v, sigma, weight=1.0, axis=0):
    """prox of sigma*||.||_21 with the signed band-sum ("MFS") norm."""
    l2_norm = v.sum(dim=axis)
    l2_soft = torch.clamp(l2_norm.abs() - sigma * weight, min=0.0) * \
        torch.sign(l2_norm)
    return v * _safe_ratio(l2_soft, l2_norm, 0.0).unsqueeze(axis)


def dual_update_21m(vp, v, lam, sigma=1.0, weight=1.0):
    """Fused dual update of the primal-dual iteration with the MFS norm:
    vtilde = vp + sigma v; v_new = vtilde (1 - soft(|sum_b vtilde|/sigma)
    / (|sum_b vtilde|/sigma))."""
    vtilde = vp + sigma * v
    vsum = vtilde.sum(dim=0).abs() / sigma
    soft = torch.clamp(vsum - lam * weight / sigma, min=0.0)
    return vtilde * (1.0 - _safe_ratio(soft, vsum, 0.0))[None]


def dual_update_21(vp, v, lam, sigma=1.0, weight=1.0):
    """Same with the l2 norm over the band axis."""
    vtilde = vp + sigma * v
    vnorm = torch.linalg.vector_norm(vtilde, dim=0) / sigma
    soft = torch.clamp(vnorm - lam * weight / sigma, min=0.0)
    return vtilde * (1.0 - _safe_ratio(soft, vnorm, 0.0))[None]
