"""The port's mesh across two processes (counterpart of
tests/test_multiprocess.py): two Python processes join through
``set_client(coordinator=...)`` (torch.distributed over gloo), each with
two virtual CPU shards, and run the JAX package's scenario: the
band-sharded PSF Hessian and power method on a (4, 1) mesh against the
JAX package's single-process ``make_psf_convolve`` and ``power_method``,
and, bit for bit against the port's one-process mesh of the same shape,
the Hessian on both engines, the PCG and the primal-dual on the band
mesh, the space-sharded Hessian on a (1, 4) mesh (K10's stages with
all-to-alls across the processes, and the distributed rFFT2), and the five
collectives across 2 x 2 shards.

Each subprocess gets a free port, one torch thread, the runtime's
120-second process-group timeout and a ``communicate`` timeout of 120 s,
so a hang fails one test instead of the suite's time limit."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120

# the scenario, run by each of the two processes on its half of the
# global mesh and by this process on a one-process mesh of the same shape;
# ``mesh_of(nband, nspace)`` builds the mesh, ``out`` receives the results
SCENARIO = r"""
import numpy as np
import torch

from pfb_tpu_torch.ops.fft import make_psfhat
from pfb_tpu_torch.ops.psf import prep_h, prep_h_space
from pfb_tpu_torch.ops.psi import make_psi
from pfb_tpu_torch.parallel import collectives as coll
from pfb_tpu_torch.parallel.collectives import world_gather
from pfb_tpu_torch.parallel.dist import (hessian_psf_dist,
                                         hessian_psf_space_dist, pcg_dist,
                                         power_method_dist,
                                         prep_psfhat_space,
                                         primal_dual_dist)
from pfb_tpu_torch.parallel.mesh import along, shard


def scenario(mesh_of, out):
    nband, nx, ny = 4, 16, 16
    nxp, nyp = 2 * nx, 2 * ny
    x = np.arange(nxp) - nx
    xx, yy = np.meshgrid(x, x, indexing="ij")
    psf = np.zeros((nband, nxp, nyp))
    for b in range(nband):
        s = 1.0 + 0.3 * b
        psf[b] = 0.5 * np.exp(-0.5 * (xx**2 + yy**2) / s**2)
        psf[b, nx, ny] += 0.5
    rng = np.random.default_rng(0)
    xc = torch.as_tensor(rng.normal(size=(nband, nx, ny)))
    psfhat = make_psfhat(torch.as_tensor(psf))

    band = mesh_of(4, 1)
    out["hess_fft"] = hessian_psf_dist(band, nyp)(xc, psfhat).numpy()
    beta, _ = power_method_dist(band, nyp, tol=1e-10, maxit=200)(xc, psfhat)
    out["beta"] = np.asarray(float(beta))
    h = [a for a in prep_h(torch.as_tensor(psf), nx, ny, torch.float64)
         if a is not None]
    out["hess_pallas"] = hessian_psf_dist(band, engine="pallas")(
        xc, *h).numpy()
    out["pcg"] = pcg_dist(band, nyp, sigmainv=1e-3, tol=1e-10, maxit=30)(
        xc, torch.zeros_like(xc), psfhat).numpy()
    psi = make_psi(nx, ny, ("self", "db1"), 2)
    v = torch.zeros((nband, psi.nbasis, psi.Nymax, psi.Nxmax),
                    dtype=xc.dtype)
    l1 = torch.ones((psi.nbasis, psi.Nymax, psi.Nxmax), dtype=xc.dtype)
    xpd, vpd, _, k = primal_dual_dist(band, psi, nyp, tol=1e-8, maxit=20)(
        torch.zeros_like(xc), v, xc, psfhat, l1, 0.1, 2.0)
    out["pd_x"], out["pd_v"] = xpd.numpy(), vpd.numpy()
    out["pd_iters"] = np.asarray(k)

    space = mesh_of(1, 4)
    hs = [a for a in prep_h_space(torch.as_tensor(psf), nx, ny, 4,
                                  torch.float64) if a is not None]
    out["space_pallas"] = hessian_psf_space_dist(space, method="pallas")(
        xc, *hs).numpy()
    out["space_fft"] = hessian_psf_space_dist(space, nyp, method="fft")(
        xc, prep_psfhat_space(psfhat, 4)).numpy()

    # the five collectives along a group across the processes: "space" on
    # the (1, 4) mesh (two shards of each process), "band" on a (2, 2)
    # mesh (one of each)
    a = torch.as_tensor(rng.normal(size=(4, 8, 12)))
    b = torch.as_tensor(rng.normal(size=(4, 4, 12)))
    for tag, mesh, axis in (("s", space, "space"),
                            ("b", mesh_of(2, 2), "band")):
        sa = shard(a, mesh, ("band", "space", None))
        sb = shard(b, mesh, ("band", "space", None))
        n = len(mesh.groups(axis)[0])
        calls = {
            "psum": (coll.psum, sa, ()),
            "all_gather": (coll.all_gather, sa, (1,)),
            "all_to_all": (coll.all_to_all, sb, (2, 1)),
            "psum_scatter": (coll.psum_scatter, sb, (2,)),
            "ppermute": (coll.ppermute, sa,
                         ([(i, (i + 1) % n) for i in range(n - 1)],)),
        }
        for name, (fn, arr, args) in calls.items():
            res = along(mesh, axis, lambda xs, devs: fn(xs, devs, *args),
                        arr.parts)
            parts = [r.clone() for r in res]
            shapes = {tuple(p.shape) for p in parts}
            assert len(shapes) == 1, (name, shapes)
            # every process's results, in mesh order
            if mesh.nproc > 1:
                parts = world_gather(parts)
            out[f"coll_{tag}_{name}"] = torch.stack(parts).numpy()
"""

WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from pfb_tpu_torch.parallel.mesh import make_mesh
from pfb_tpu_torch.parallel.runtime import set_client

pid = int(sys.argv[1])
mesh = set_client(nband=4, precision="double",
                  coordinator="127.0.0.1:{port}", num_processes=2,
                  process_id=pid, devices=["cpu"] * 2)
assert mesh.size == 4 and len(mesh.devices) == 2 and mesh.offset == 2 * pid
{scenario}
out = {{}}
scenario(lambda nb, ns: make_mesh(nb, ns, devices=["cpu"] * 2), out)
np.savez(sys.argv[2], **out)
print("proc", pid, "ok", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both processes' results and the one-process mesh's."""
    tmp = tmp_path_factory.mktemp("mp")
    code = WORKER.format(repo=REPO, port=_free_port(), scenario=SCENARIO)
    outs = [str(tmp / f"o{i}.npz") for i in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i), outs[i]],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=_env())
             for i in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, lg[-3000:]

    from pfb_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    ns = {}
    exec(SCENARIO, ns)
    ref = {}
    ns["scenario"](lambda nb, nsp: make_mesh(nb, nsp, devices=["cpu"] * 4),
                   ref)
    return [dict(np.load(o)) for o in outs], ref


def test_band_mesh_matches_jax_single_process(runs):
    import jax.numpy as jnp

    from pfb_tpu.ops.fft import make_psfhat
    from pfb_tpu.ops.psf import make_psf_convolve
    from pfb_tpu.opt.power_method import power_method

    nband, nx, ny = 4, 16, 16
    nxp, nyp = 2 * nx, 2 * ny
    x = np.arange(nxp) - nx
    xx, yy = np.meshgrid(x, x, indexing="ij")
    psf = np.zeros((nband, nxp, nyp))
    for b in range(nband):
        s = 1.0 + 0.3 * b
        psf[b] = 0.5 * np.exp(-0.5 * (xx**2 + yy**2) / s**2)
        psf[b, nx, ny] += 0.5
    psfhat = make_psfhat(jnp.asarray(psf))
    xc = np.random.default_rng(0).normal(size=(nband, nx, ny))
    ref = np.asarray(make_psf_convolve(psfhat, nyp)(jnp.asarray(xc)))
    beta_ref, _ = power_method(
        make_psf_convolve(psfhat, nyp), (nband, nx, ny), tol=1e-10,
        maxit=200, dtype=jnp.float64)
    for d in runs[0]:
        np.testing.assert_allclose(d["hess_fft"], ref, rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(d["beta"], float(beta_ref), rtol=1e-8)


@pytest.mark.parametrize("key", ["hess_fft", "beta", "hess_pallas", "pcg",
                                 "pd_x", "pd_v", "pd_iters", "space_pallas",
                                 "space_fft"])
def test_two_processes_equal_one_process_mesh(runs, key):
    """Bit for bit: the sums across processes are taken in mesh order."""
    procs, ref = runs
    for d in procs:
        assert d[key].shape == ref[key].shape
        assert np.array_equal(d[key], ref[key]), \
            np.abs(d[key] - ref[key]).max()


@pytest.mark.parametrize("tag", ["s", "b"])
@pytest.mark.parametrize("name", ["psum", "all_gather", "all_to_all",
                                  "psum_scatter", "ppermute"])
def test_collectives_across_processes(runs, tag, name):
    procs, ref = runs
    key = f"coll_{tag}_{name}"
    for d in procs:
        assert np.array_equal(d[key], ref[key])


def test_rendezvous_without_peer_fails_within_its_timeout(tmp_path):
    """A process whose peers never come fails at the runtime's timeout
    (shortened here) instead of hanging."""
    code = (f"import sys; sys.path.insert(0, {REPO!r})\n"
            "import time\n"
            "from pfb_tpu_torch.parallel import runtime\n"
            "runtime.TIMEOUT_S = 3\n"
            "t0 = time.perf_counter()\n"
            "try:\n"
            f"    runtime.set_client(coordinator='127.0.0.1:{_free_port()}',"
            " num_processes=2, process_id=0, devices=['cpu'])\n"
            "except Exception as e:\n"
            "    print('failed after', time.perf_counter() - t0,"
            " type(e).__name__)\n"
            "    sys.exit(3)\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=TIMEOUT, env=_env())
    assert p.returncode == 3, p.stdout + p.stderr
    assert float(p.stdout.split()[2]) < 30


def test_mesh_refuses_layouts_its_collectives_cannot_run():
    """A group across processes holds as many shards of each (checked
    where make_mesh builds a multi-process mesh): a (3, 2) mesh over two
    processes of three shards each puts two of band group [0, 2, 4] in
    process 0 and one in process 1."""
    from pfb_tpu_torch.parallel.mesh import Mesh
    cpu = torch.device("cpu")
    m = Mesh(3, 2, [cpu] * 3, rank=0, nproc=2)
    assert m.size == 6 and list(m.local) == [0, 1, 2] and 2 in m.local
    with pytest.raises(ValueError, match="as many"):
        m.check_spans()
    ok = Mesh(2, 2, [cpu] * 2, rank=1, nproc=2)
    ok.check_spans()
    assert ok.offset == 2 and 1 not in ok.local
    with pytest.raises(ValueError, match="shards over"):
        Mesh(2, 2, [cpu] * 3, rank=0, nproc=2)
