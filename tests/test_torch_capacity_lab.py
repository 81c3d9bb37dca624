"""The L3 lab's operations (scripts/torch_capacity_lab.py) against the TPU
lab scripts/wl_capacity_ab.py, CPU:

- ops/pgridder.py:pack_entries + the plain K4 (pg_spread_plain, float64)
  at pair width P = 1 and 2 against the probe kernel of
  wl_capacity_ab.py:81-106, rebuilt here as an interpret-mode
  pallas_call (float32; importing the lab would set a JAX
  compilation-cache directory): 1e-5 of max, tile by tile; the TPU
  kernel's output starts from zeros through an aliased input (interpret
  mode fills an output with NaN), its body is unchanged;
- the port's _spread_fold (plain K4 + K5) at capacity 128, 256 and 512
  against the JAX package's _spread_fold with its Pallas kernels in
  interpret mode: 1e-12 of max (float64, tests/test_torch_pgridder.py's
  gate);
- the lab's --device cpu rehearsal.
"""

import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pfb_tpu.ops import pgridder as pg_j
from pfb_tpu_torch.ops import pgridder as pg_t

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _observation(nrow, nchan, seed=0):
    """wl_capacity_ab.py's observation at a small size."""
    rng = np.random.default_rng(seed)
    uvw = rng.normal(scale=1000.0, size=(nrow, 3))
    uvw[:, 2] *= 0.1
    freq = np.linspace(0.9e9, 1.1e9, nchan)
    umax = np.abs(uvw[:, :2]).max() * freq[-1] / 299792458.0
    return uvw, freq, 1.0 / (2.0 * umax * 2.0), rng


def _probe_jax(p1, P, visE):
    """wl_capacity_ab.py:probe's pallas_call at pair width P, in
    interpret mode, on the plan p1 and the per-entry visibilities visE
    (E, 2, C); the kernel body is the lab's."""
    E = p1["pos"].shape[0] // P * P
    posP = jnp.asarray(p1["pos"])[:E].reshape(E // P, P, 8, p1["C"])
    posP = jnp.concatenate([posP[:, i] for i in range(P)], axis=-1)
    tidP = jnp.asarray(p1["tid"])[:E:P]
    visP = jnp.asarray(visE)[:E].reshape(E // P, P, 2, p1["C"])
    visP = jnp.concatenate([visP[:, i] for i in range(P)], axis=-1)
    k, beta, nw = p1["k"], p1["beta"], p1["nw"]
    Thx, Thy, C = p1["txs"] + k, p1["tys"] + k, P * p1["C"]

    def kern(tp_ref, pk_ref, vis_ref, out_ref, *, prec):
        dt = out_ref.dtype
        kh = k / 2.0
        u = pk_ref[0, 0, :]
        v = pk_ref[0, 1, :]
        wf = pk_ref[0, 2, :]
        xs = jax.lax.broadcasted_iota(jnp.int32, (Thx, C),
                                      0).astype(dt)
        CUT = pg_j._es((xs - u[None, :]) / kh, beta, k)
        ys = jax.lax.broadcasted_iota(jnp.int32, (C, Thy),
                                      1).astype(dt)
        CV = pg_j._es((ys - v[:, None]) / kh, beta, k)
        ps = jax.lax.broadcasted_iota(jnp.int32, (nw, C),
                                      0).astype(dt)
        CW = pg_j._es((ps - wf[None, :]) / kh, beta, k)
        A = (CW[:, None, :] * CUT[None, :, :]).reshape(nw * Thx, C)
        vr_ = vis_ref[0, 0, :]
        vi_ = vis_ref[0, 1, :]
        CVv = jnp.concatenate([CV * vr_[:, None], CV * vi_[:, None]],
                              axis=1)
        res = lax.dot_general(A, CVv, (((1,), (0,)), ((), ())),
                              precision=prec,
                              preferred_element_type=dt)
        res = res.reshape(nw, Thx, 2 * Thy)
        out_ref[0, :, 0] += res[..., :Thy]
        out_ref[1, :, 0] += res[..., Thy:]

    ntiles = int(p1["ntx"]) * int(p1["nty"])
    out_spec = pl.BlockSpec((2, nw, 1, Thx, Thy),
                            lambda e, t: (0, 0, t[e], 0, 0))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(E // P,),
        in_specs=[pl.BlockSpec((1, 8, C), lambda e, *_: (e, 0, 0)),
                  pl.BlockSpec((1, 2, C), lambda e, *_: (e, 0, 0)),
                  out_spec],
        out_specs=out_spec)
    body = partial(kern, prec=lax.Precision.HIGHEST)
    zeros = jnp.zeros((2, nw, ntiles, Thx, Thy), jnp.float32)
    return pl.pallas_call(
        lambda tp, pk, vis, _z, out: body(tp, pk, vis, out),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct(zeros.shape, jnp.float32),
        input_output_aliases={3: 0}, interpret=True,
    )(tidP.astype(jnp.int32), posP, visP, zeros)


@pytest.fixture(scope="module")
def probe_plan():
    uvw, freq, cell, rng = _observation(1500, 4)
    pj = pg_j.pgrid_plan(uvw, freq, nx=128, ny=128, cellx=cell, celly=cell,
                         epsilon=1e-5, do_wgridding=True, dtype=np.float32)
    visE = (rng.normal(size=(pj["nentries"], 2, pj["C"]))
            * np.asarray(pj["pm"])[:, None]).astype(np.float32)
    return pj, visE


@pytest.mark.parametrize("P", [1, 2])
def test_paired_probe_matches_jax_probe(probe_plan, P):
    pj, visE = probe_plan
    assert pj["nw"] > 1 and pj["nentries"] > 20
    ref = np.asarray(_probe_jax(pj, P, visE))
    pt = pg_t.plan_from_jax(pj, dtype=torch.float64)
    k = pt["k"]
    pk = pg_t.pack_entries(pt["pos"], torch.as_tensor(visE, dtype=torch.float64),
                           pt["tid"], pt["pm"], P, ntx=pt["ntx"],
                           nty=pt["nty"], txs=pt["txs"], tys=pt["tys"], k=k)
    E = pt["nentries"] // P
    assert pk["pos"].shape == (E, 8, P * pt["C"])
    assert pk["vis"].shape == (E, 2, P * pt["C"])
    assert torch.equal(pk["tid"], pt["tid"][:E * P:P])
    sl = pk["slots"]
    got = pg_t.pg_spread(pk["pos"], pk["vis"], sl, beta=pt["beta"], k=k,
                         nw=pt["nw"], Thx=pt["txs"] + k, Thy=pt["tys"] + k)
    live = sl["live"].numpy()
    tiles = sl["tile"].numpy()[live]
    # every step lands on its first entry's tile: the tiles the TPU probe
    # wrote are the live slots' tiles
    written = np.nonzero(np.abs(ref).reshape(2 * pt["nw"], ref.shape[2],
                                             -1).max(axis=(0, 2)))[0]
    assert set(written) <= set(tiles.tolist())
    g = got.numpy()[:, :, live]
    r = ref[:, :, tiles]
    assert np.abs(g - r).max() < TOL * np.abs(r).max()


def test_pack_entries_drops_the_odd_entry_and_p1_is_the_plan(probe_plan):
    pj, visE = probe_plan
    pt = pg_t.plan_from_jax(pj, dtype=torch.float64)
    geo = dict(ntx=pt["ntx"], nty=pt["nty"], txs=pt["txs"], tys=pt["tys"],
               k=pt["k"])
    vis = torch.as_tensor(visE, dtype=torch.float64)
    one = pg_t.pack_entries(pt["pos"], vis, pt["tid"], pt["pm"], 1, **geo)
    assert torch.equal(one["pos"], pt["pos"]) and torch.equal(one["vis"], vis)
    ref = pg_t._compact_slots(pt["tid"], pt["pm"], **geo)
    assert all(torch.equal(one["slots"][key], ref[key])
               for key in ("start", "count", "tslot"))
    NE = pt["nentries"]
    three = pg_t.pack_entries(pt["pos"], vis, pt["tid"], pt["pm"], 3, **geo)
    assert three["pos"].shape[0] == NE // 3
    # entry 3 e + i sits at columns [i C, (i + 1) C) of packed step e
    C = pt["C"]
    assert torch.equal(three["pos"][1, :, C:2 * C], pt["pos"][4])
    assert torch.equal(three["pm"][1, 2 * C:], pt["pm"][5])


@pytest.mark.parametrize("capacity", [128, 256, 512])
def test_spread_fold_capacity_matches_jax_interpret(capacity):
    uvw, freq, cell, rng = _observation(800, 4, seed=capacity)
    pj = pg_j.pgrid_plan(uvw, freq, nx=128, ny=128, cellx=cell, celly=cell,
                         epsilon=1e-5, do_wgridding=True, capacity=capacity)
    assert pj["C"] == capacity
    pt = pg_t.plan_from_jax(pj)
    vr, vi = (rng.normal(size=(800, 4)) for _ in range(2))
    st = {key: pj[key] for key in ("beta", "k", "nw", "ntx", "nty", "txs",
                                   "tys", "C", "x0", "y0", "Nx", "Ny")}
    ref = pg_j._spread_fold(jnp.asarray(vr), jnp.asarray(vi), None,
                            pj["tid"], pj["pos"], pj["idx"], pj["pm"],
                            pj["uvw_d"], pj["freq_d"], interpret=True, **st)
    got = pg_t._spread_fold(torch.as_tensor(vr), torch.as_tensor(vi), None,
                            pt["tid"], pt["pos"], pt["idx"], pt["pm"],
                            pt["uvw_d"], pt["freq_d"], **st)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (2 * pj["nw"], pj["Nx"], pj["Ny"])
    assert np.abs(got.numpy() - ref).max() < 1e-12 * np.abs(ref).max()


def test_lab_cpu_rehearsal():
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable,
                          str(ROOT / "scripts" / "torch_capacity_lab.py"),
                          "--device", "cpu"], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(s) for s in res.stdout.strip().splitlines()]
    summary = lines[-1]
    assert summary["ok"] and summary["card"] == "cpu"
    assert sorted(summary["spread_fold_ms"]) == ["128", "256", "512"]
    assert len(lines) == 6
    assert time.perf_counter() - t0 < 20
