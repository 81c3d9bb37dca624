"""The port's public surface is the JAX package's: every public top-level
function and class of each ``pfb_tpu/**/*.py`` exists in its
``pfb_tpu_torch`` counterpart (same path; ``ops/pallas_cfft.py`` ->
``ops/cfft.py``), defined, imported or assigned there, except the rows of
the recorded tables below, each of which names a counterpart that must
exist. Both packages are read with ``ast``: neither is imported."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "pfb_tpu", ROOT / "pfb_tpu_torch"
MODULE_MAP = {"ops/pallas_cfft.py": "ops/cfft.py"}

_PF = "ops/pallas_fft.py"
# renames and moves: (JAX module, name) -> (port module, name)
MOVED = {
    ("parallel/dwt_halo.py", "halo_psi_dot_local"):
        ("parallel/dwt_halo.py", "halo_psi_dot"),
    ("parallel/dwt_halo.py", "halo_psi_hdot_local"):
        ("parallel/dwt_halo.py", "halo_psi_hdot"),
    ("ops/psf.py", "prep_pallas_hessian"): ("ops/psf.py", "prep_h"),
    ("ops/psf.py", "prep_pallas_hessian_space"):
        ("ops/psf.py", "prep_h_space"),
    (_PF, "psf_convolve_pallas_v3_cube"): ("ops/psf.py", "psf_convolve_h"),
    (_PF, "psf_convolve_pallas_v3_cube_cg"):
        ("ops/psf.py", "psf_convolve_h_cg"),
    (_PF, "psf_v3_stage_k1"): ("ops/psf.py", "psf_stage_cols_fwd"),
    (_PF, "psf_v3_stage_k2"): ("ops/psf.py", "psf_stage_rows"),
    (_PF, "psf_v3_stage_k3"): ("ops/psf.py", "psf_stage_cols_inv"),
}
# the CLI's commands are built in a loop over this dict's keys
COMMANDS = ("workers/main.py", "_COMMANDS")
# out on purpose (ROADMAP.md, Decisions): the port computes these
# functions elsewhere, named here
OUT = {
    ("config.py", "on_tpu"): ("config.py", "default_device"),
    ("parallel/mesh.py", "band_sharding"): ("parallel/mesh.py", "shard"),
    ("parallel/mesh.py", "coeff_sharding"): ("parallel/mesh.py", "shard"),
    ("parallel/mesh.py", "replicated"): ("parallel/mesh.py", "shard"),
    ("ops/mmfft.py", "fft_mm_last"): ("ops/cfft.py", "fftx_c2c"),
    ("ops/mmfft.py", "fft2_mm"): ("ops/cfft.py", "fft2_c2c_pruned"),
    ("ops/mmfft.py", "psf_convolve_mm"): ("ops/psf.py", "psf_convolve_full"),
    ("ops/mmgridder.py", "mm_plan"): ("ops/pgridder.py", "pgrid_plan"),
    ("ops/mmgridder.py", "vis2dirty_mm"): ("ops/pgridder.py", "vis2dirty_pg"),
    ("ops/mmgridder.py", "dirty2vis_mm"): ("ops/pgridder.py", "dirty2vis_pg"),
    # the TPU matmul FFTs' DFT-matrix constants; the CUDA kernels take
    # twiddle tables
    (_PF, "consts_for"): ("kernels.py", "twiddles"),
    (_PF, "consts_lane_for"): ("kernels.py", "twiddles"),
    (_PF, "consts_lane_tw_for"): ("kernels.py", "twiddles"),
    (_PF, "consts_k1t_for"): ("kernels.py", "twiddles"),
    (_PF, "consts_k3t_for"): ("kernels.py", "twiddles"),
    # the port's program spans, on while a torch profiler runs
    ("utils/profiling.py", "compute_context"): ("utils/profiling.py", "span"),
    ("utils/profiling.py", "PhaseTimer"): ("utils/profiling.py", "span"),
}


def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def _public(path):
    """Public top-level functions and classes defined in ``path``."""
    return {n.name for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def _names(path):
    """Every top-level name bound in ``path``: defined, assigned or
    imported."""
    out = set()
    for n in _tree(path).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                out |= {e.id for e in ast.walk(t) if isinstance(e, ast.Name)}
    return out


def _dict_keys(path, name):
    for n in _tree(path).body:
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in n.targets):
            return {ast.literal_eval(k) for k in n.value.keys}
    raise AssertionError(f"{path} binds no dict {name}")


def _modules():
    return sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def _counterpart(rel):
    return PORT / MODULE_MAP.get(rel, rel)


@pytest.mark.parametrize("rel", _modules())
def test_every_public_function_of_the_module_is_ported(rel):
    port = _counterpart(rel)
    assert port.exists(), f"pfb_tpu/{rel} has no counterpart {port}"
    have = _names(port)
    commands = _dict_keys(PORT / COMMANDS[0], COMMANDS[1]) \
        if rel == COMMANDS[0] else set()
    missing = []
    for name in sorted(_public(JAX / rel)):
        if (rel, name) in MOVED or (rel, name) in OUT:
            continue
        if name in have or name in commands:
            continue
        missing.append(name)
    assert not missing, f"pfb_tpu/{rel}: not in {port.relative_to(ROOT)}: " \
        f"{missing}"


@pytest.mark.parametrize("table", ["moved", "out"])
def test_recorded_exceptions_name_existing_counterparts(table):
    """Each row's JAX function exists (a stale row fails) and so does
    the port's counterpart; a moved function is not also at its old
    path."""
    rows = MOVED if table == "moved" else OUT
    for (rel, name), (prel, pname) in rows.items():
        assert name in _public(JAX / rel), f"pfb_tpu/{rel}:{name} is gone"
        assert pname in _names(PORT / prel), \
            f"pfb_tpu_torch/{prel}:{pname} is missing"
        assert name not in _names(_counterpart(rel)), \
            f"pfb_tpu_torch/{rel} has {name}: drop its row"


def test_cli_commands_are_the_jax_package_commands():
    """workers/main.py: the JAX package defines a click command a worker;
    the port builds the same ones from _COMMANDS."""
    jax_cmds = {n.name for n in _tree(JAX / COMMANDS[0]).body
                if isinstance(n, ast.FunctionDef) and any(
                    "command" in ast.unparse(d) for d in n.decorator_list)}
    port = _dict_keys(PORT / COMMANDS[0], COMMANDS[1])
    assert jax_cmds - {"pipeline"} == port
    assert "pipeline" in _names(PORT / COMMANDS[0])


def test_the_package_exports_its_precision_policy():
    """pfb_tpu/__init__.py's imports exist in pfb_tpu_torch/__init__.py."""
    def imported(path):
        return {a.asname or a.name for n in _tree(path).body
                if isinstance(n, ast.ImportFrom) for a in n.names}
    assert imported(JAX / "__init__.py") <= imported(PORT / "__init__.py")
