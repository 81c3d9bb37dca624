"""The control: the reference put in the program's place in the next
precision below the configuration's (float32 with TF32 operands), at a
small size on the CPU. It has to come out not correct against the
cell's limits, with its numbers well above the program's."""

import time

import pytest
import torch

from bench_helpers import SEED, small_parts
from harness import main
from harness.simobs import observation


@pytest.mark.parametrize("workload", ["syn64_2k.spotless",
                                      "syn64_2k.fluxmop_vis"])
def test_control_is_not_correct(workload):
    p = small_parts(workload)
    if "cg_maxit" in p["traffic"]["call"]:
        p["traffic"] = dict(p["traffic"], call=dict(
            p["traffic"]["call"], cg_maxit=30, cg_minit=30))
    unit = p["unit"]
    cpu = torch.device("cpu")
    _, _, numbers = main.run_cell(p, SEED, 0.0, 0, cpu, time.perf_counter())
    cols, _ = observation(p["cfg"], SEED)
    obs = unit.observe({"cols": cols}, p["cfg"], cpu)
    ref = unit.reference(obs, p["cfg"], p["traffic"])
    ctl = unit.compare(unit.reference(obs, p["cfg"], p["traffic"],
                                      control=True), ref)
    assert any(ctl[k] > lim for k, lim in p["limits"].items()), ctl
    assert all(v <= lim for v, lim in numbers.values()), numbers
    assert max(ctl[k] / numbers[k][0] for k in numbers) > 3.0, (ctl, numbers)
