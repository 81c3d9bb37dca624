"""The benchmark's roofline arithmetic against chip_smoke.py's."""

import importlib.util

import pytest

from harness import roofline
from bench_helpers import BENCH


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_original", BENCH.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(8, 2048, 2048, 4096, 4096, 8 * 2049 *
                                    4096, True),
                                   (8, 3072, 3072, 6144, 6144, 8 * 6144 *
                                    6144, True),
                                   (2, 128, 128, 256, 256, 2 * 129 * 256,
                                    False)])
def test_copy_matches_chip_smoke(shape):
    cs = _chip_smoke()
    assert roofline.conv_work(*shape) == cs.conv_work(*shape)
    assert roofline.bound(*roofline.conv_work(*shape)) == \
        cs.bound(*cs.conv_work(*shape))
    assert roofline.fft_flops(4096, 17, real=True) == \
        cs.fft_flops(4096, 17, real=True)
    assert (roofline.HBM_BPS, roofline.FP32_FLOPS, roofline.BF16_TC_FLOPS) \
        == (cs.HBM_BPS, cs.FP32_FLOPS, cs.BF16_TC_FLOPS)
