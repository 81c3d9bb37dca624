"""The L2 lab's operations (scripts/torch_g2i_lab.py) against the TPU lab
scripts/wl_g2i_lab.py, CPU:

- the split-precision x pass: the port's plain version (ops/cfft.py:
  fftx_c2c_split_plain, float32) against the JAX package's
  fftx_c2c(precision="split", interpret=True), 1e-5 of max (the same
  split arithmetic in another summation order), and each against a
  float64 FFT;
- the copy probes' plain versions (ops/memlab.py) against the bodies of
  wl_g2i_lab.py's k1io / krow / ksplit / kbatch, rebuilt here as
  interpret-mode pallas_calls (importing the lab would set a JAX
  compilation-cache directory): exact;
- fftx_c2c_lab's plain routes (explicit S, the first radix pass), the
  pre-transposed "no transpose" variant, and the lab's --device cpu
  rehearsal.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pfb_tpu.ops.pallas_cfft import fftx_c2c as fftx_c2c_jax
from pfb_tpu_torch.ops import cfft as cf
from pfb_tpu_torch.ops import memlab

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _rel2(a, b):
    """max|a - b| / max|b| over (re, im) pairs."""
    num = max(np.abs(np.asarray(x) - np.asarray(y)).max() for x, y in zip(a, b))
    return num / max(np.abs(np.asarray(y)).max() for y in b)


@pytest.mark.parametrize("N,inverse,out_rolled", [
    (512, True, True), (512, False, False), (1024, True, True),
    (1024, False, True)])
def test_split_plain_matches_jax_split(N, inverse, out_rolled):
    rng = np.random.default_rng(N + inverse)
    xr, xi = (rng.normal(size=(2, N, 128)).astype(np.float32)
              for _ in range(2))
    kw = dict(N=N, inverse=inverse, out_rolled=out_rolled)
    ref = fftx_c2c_jax(jnp.asarray(xr), jnp.asarray(xi), interpret=True,
                       precision="split", **kw)
    got = cf.fftx_c2c_split_plain(torch.as_tensor(xr), torch.as_tensor(xi),
                                  **kw)
    assert got[0].shape == ref[0].shape == (2, N // 2 if out_rolled else N,
                                            128)
    assert _rel2(got, ref) < TOL
    # each package's own error against the float64 transform: the split
    # products keep about 16 bits (the JAX docstring's ~1e-5 a stage)
    f64 = cf.fftx_c2c_plain(torch.as_tensor(xr, dtype=torch.float64),
                            torch.as_tensor(xi, dtype=torch.float64), **kw)
    e_port, e_jax = _rel2(got, f64), _rel2(ref, f64)
    print(f"N={N}: split vs float64, port {e_port:.2e}, JAX {e_jax:.2e}")
    assert 1e-7 < e_port < 2e-5 and 1e-7 < e_jax < 2e-5


def test_split_wrapper_routes_and_checks():
    """The CPU wrapper runs the plain version; in_rolled as the JAX
    constants select its n1 blocks; unsupported lengths raise."""
    rng = np.random.default_rng(3)
    xr, xi = (torch.as_tensor(rng.normal(size=(1, 256, 128)).astype(
        np.float32)) for _ in range(2))
    kw = dict(N=512, inverse=False, in_rolled=True)
    got = cf.fftx_c2c_split(xr, xi, **kw)
    ref = fftx_c2c_jax(jnp.asarray(xr.numpy()), jnp.asarray(xi.numpy()),
                       interpret=True, precision="split", **kw)
    assert _rel2(got, ref) < TOL
    with pytest.raises(ValueError):   # 96 = 12 x 8: not cfft_supported
        cf.fftx_c2c_split(xr[:, :96], xi[:, :96], N=96)
    with pytest.raises(ValueError):
        cf.fftx_c2c_split(xr, xi, N=512)


def _copy_jax(kind, x, S=128):
    """wl_g2i_lab.py's copy kernels k1io (:296), krow (:319), ksplit
    (:348) and kbatch (:376) in interpret mode on a (P, N, N) stack."""
    P, N, _ = x.shape
    Nout = N // 2
    f32 = jnp.float32
    vm = dict(memory_space=pltpu.VMEM)
    if kind == "strip":
        def k1io(x_ref, o_ref):
            o_ref[...] = x_ref[:, :Nout]
        return pl.pallas_call(
            k1io, grid=(P, N // 128),
            in_specs=[pl.BlockSpec((1, N, 128), lambda p, j: (p, 0, j),
                                   **vm)],
            out_specs=pl.BlockSpec((1, Nout, 128), lambda p, j: (p, 0, j),
                                   **vm),
            out_shape=jax.ShapeDtypeStruct((P, Nout, N), f32),
            interpret=True)(x)
    if kind == "batched":
        def kbatch(x_ref, o_ref):
            o_ref[...] = x_ref[:, :Nout]
        return pl.pallas_call(
            kbatch, grid=(N // 128,),
            in_specs=[pl.BlockSpec((P, N, 128), lambda j: (0, 0, j), **vm)],
            out_specs=pl.BlockSpec((P, Nout, 128), lambda j: (0, 0, j),
                                   **vm),
            out_shape=jax.ShapeDtypeStruct((P, Nout, N), f32),
            interpret=True)(x)
    if kind == "rows":
        def krow(x_ref, o_ref):
            o_ref[...] = x_ref[..., :Nout]
        body = krow
    else:
        N1s = N // 128

        def ksplit(x_ref, o_ref):
            xb = x_ref[0]
            parts = [xb[:, j * 128:(j + 1) * 128] for j in range(N1s)]
            st = jnp.concatenate(parts, axis=0)
            st = st + 1.0
            outp = [st[j * S:(j + 1) * S] for j in range(N1s // 2)]
            o_ref[0] = jnp.concatenate(outp, axis=1)
        body = ksplit
    return pl.pallas_call(
        body, grid=(P, N // S),
        in_specs=[pl.BlockSpec((1, S, N), lambda p, j: (p, j, 0), **vm)],
        out_specs=pl.BlockSpec((1, S, Nout), lambda p, j: (p, j, 0), **vm),
        out_shape=jax.ShapeDtypeStruct((P, N, Nout), f32),
        interpret=True)(x)


@pytest.mark.parametrize("mode,S", [("strip", None), ("rows", 64),
                                    ("rows", 128), ("rows", 256),
                                    ("relayout", 128), ("batched", None)])
def test_copy_modes_match_jax_copy_kernels(mode, S):
    """Each mode's plain version (and the CPU wrapper, at the TPU lab's S)
    equals the TPU lab's copy kernel exactly; ksplit adds 1.0, as the
    relayout mode does."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 512, 512)).astype(np.float32)
    ref = np.asarray(_copy_jax(mode, jnp.asarray(x), S=S or 128))
    xt = torch.as_tensor(x)
    plain, none = memlab.lab_copy_plain(mode, xt)
    assert none is None
    np.testing.assert_array_equal(plain.numpy(), ref)
    got, _ = memlab.lab_copy(mode, xt, S=S)
    np.testing.assert_array_equal(got.numpy(), ref)
    two = memlab.lab_copy(mode, xt, xt + 1.0, S=S)
    np.testing.assert_array_equal(two[1].numpy(),
                                  memlab.lab_copy_plain(mode, xt + 1.0)[0])


def test_copy_checks_and_default_S():
    x = torch.zeros((1, 512, 512))
    assert memlab.default_S("strip", 8192) == 1
    assert memlab.default_S("strip", 2048) == 4
    assert memlab.default_S("rows", 8192) == 64
    assert memlab.default_S("relayout", 8192) == 128
    for bad in (dict(mode="relayout", S=16), dict(mode="strip", S=64),
                dict(mode="rows", S=100), dict(mode="diagonal", S=None)):
        with pytest.raises(ValueError):
            memlab.lab_copy(bad["mode"], x, S=bad["S"])
    with pytest.raises(ValueError):   # not square
        memlab.lab_copy("rows", torch.zeros((1, 512, 256)))


@pytest.mark.parametrize("N", [512, 384, 960])
@pytest.mark.parametrize("inverse", [False, True])
def test_cfft_lab_plain_routes(N, inverse):
    """An explicit S gives fftx_c2c's answer; npass=1 gives the plan's
    first radix pass, written out here as a direct sum."""
    rng = np.random.default_rng(N)
    xr, xi = (torch.as_tensor(rng.normal(size=(2, N, 3))) for _ in range(2))
    kw = dict(N=N, inverse=inverse, out_rolled=True)
    got = cf.fftx_c2c_lab(xr, xi, S=2, **kw)
    ref = cf.fftx_c2c(xr, xi, **kw)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    fr, fi = cf.fftx_c2c_lab(xr, xi, npass=1, **kw)
    R = {512: 16, 384: 16, 960: 16}[N]
    z = (xr + 1j * xi).numpy()
    sg = 1.0 if inverse else -1.0
    W = np.exp(sg * 2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
    y = np.einsum("qm,pqjl->pjml", W, z.reshape(2, R, N // R, 3))
    y = y.reshape(2, N, 3)[:, (np.arange(N // 2) - N // 4) % N]
    np.testing.assert_allclose(fr.numpy(), y.real, atol=1e-10)
    np.testing.assert_allclose(fi.numpy(), y.imag, atol=1e-10)
    with pytest.raises(ValueError):
        cf.fftx_c2c_lab(xr, xi, npass=2, **kw)
    with pytest.raises(ValueError):
        cf.fftx_c2c_lab(xr, xi, S=64, **kw)


def test_no_transpose_variant_is_the_transposed_x_pass():
    """K3 on contiguous lines of the pre-transposed stack (the lab's
    k_notr counterpart) gives the x pass's rows, transposed."""
    rng = np.random.default_rng(5)
    P, N = 2, 256
    xr, xi = (torch.as_tensor(rng.normal(size=(P, N, N))) for _ in range(2))
    kw = dict(N=N, inverse=True, out_rolled=True)
    yr, yi = cf.fftx_c2c(xr, xi, **kw)
    tr, ti = (a.transpose(-1, -2).contiguous().view(P * N, N, 1)
              for a in (xr, xi))
    zr, zi = cf.fftx_c2c(tr, ti, **kw)
    assert torch.allclose(zr.view(P, N, N // 2).transpose(-1, -2), yr,
                          atol=1e-9)
    assert torch.allclose(zi.view(P, N, N // 2).transpose(-1, -2), yi,
                          atol=1e-9)


@pytest.mark.parametrize("section", [[], ["--floor"]])
def test_lab_cpu_rehearsal(section):
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable,
                          str(ROOT / "scripts" / "torch_g2i_lab.py"),
                          "--device", "cpu", *section], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["ok"] and summary["card"] == "cpu"
    assert summary["section"] == ("floor" if section else "main")
    assert time.perf_counter() - t0 < 20
