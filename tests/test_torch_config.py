"""pfb_tpu_torch's precision policy and host/device moves (config.py) and
utils/dstore.py:remove_store against pfb_tpu's, on the CPU."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pfb_tpu_torch
from pfb_tpu import config as config_j
from pfb_tpu.utils import dstore as dstore_j
from pfb_tpu_torch import config as config_t
from pfb_tpu_torch.utils import dstore as dstore_t

pmp = pytest.mark.parametrize


@pytest.fixture
def restore_precision():
    """Both packages' precision as the test found it."""
    before = config_t._PRECISION, config_j._PRECISION
    yield
    config_t._PRECISION, config_j._PRECISION = before


def _name(dtype):
    return str(dtype).replace("torch.", "")


@pmp("precision", ["single", "double"])
def test_precision_policy_matches_jax(precision, restore_precision):
    default = torch.get_default_dtype()
    pfb_tpu_torch.set_precision(precision)
    config_j.set_precision(precision)
    assert pfb_tpu_torch.default_real_dtype is config_t.default_real_dtype
    assert _name(config_t.default_real_dtype()) == \
        np.dtype(config_j.default_real_dtype()).name
    assert _name(config_t.default_complex_dtype()) == \
        np.dtype(config_j.default_complex_dtype()).name
    for real in (torch.float32, torch.float64):
        assert _name(config_t.complex_for(real)) == \
            np.dtype(config_j.complex_for(getattr(jnp, _name(real)))).name
    # the port's kernels are float32-only: torch's default stays
    assert torch.get_default_dtype() is default


def test_set_precision_refuses_other_names(restore_precision):
    with pytest.raises(ValueError, match="half"):
        config_t.set_precision("half")


@pmp("default", ["float32", "float64"])
def test_initial_precision_follows_the_default_dtype(default):
    """A fresh process: 'double' where torch's default dtype is float64
    when the port is imported, else 'single'."""
    code = (f"import torch; torch.set_default_dtype(torch.{default}); "
            "from pfb_tpu_torch import config; "
            "print(config.default_real_dtype())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout.strip()
    assert out == f"torch.{default}"


@pmp("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_to_device_and_to_host_round_trip(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 4))
    if np.iscomplexobj(np.zeros(1, dtype)):
        x = x + 1j * rng.normal(size=x.shape)
    x = x.astype(dtype)[:, ::-1]  # a negative stride
    t = config_t.to_device(x, device="cpu")
    assert t.device.type == "cpu" and t.dtype == torch.as_tensor(
        np.zeros(1, dtype)).dtype
    back = config_t.to_host(t)
    assert isinstance(back, np.ndarray) and back.dtype == dtype
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(back, config_j.to_host(
        config_j.to_device(x)))


def test_to_device_casts_and_to_host_takes_numpy():
    x = np.arange(6.0).reshape(2, 3)
    t = config_t.to_device(x, dtype=torch.complex64, device="cpu")
    assert t.dtype == torch.complex64
    np.testing.assert_array_equal(config_t.to_host(t), x.astype(np.complex64))
    np.testing.assert_array_equal(config_t.to_host(x), x)


def test_to_device_defaults_to_the_default_device():
    t = config_t.to_device(np.ones(3))
    assert t.device.type == config_t.default_device().type


@pmp("remove", [dstore_t.remove_store, dstore_j.remove_store])
def test_remove_store(tmp_path, remove):
    """A store write_store wrote goes; a missing path is no error."""
    path = tmp_path / "x.dds"
    dstore_t.write_store(path, [{"A": np.ones((2, 3)), "b": 1.0}])
    assert dstore_t.store_exists(path)
    assert len(dstore_t.read_store(path)) == 1
    remove(path)
    assert not path.exists() and not dstore_t.store_exists(path)
    remove(path)
    remove(str(tmp_path / "never"))
    assert tmp_path.exists()
