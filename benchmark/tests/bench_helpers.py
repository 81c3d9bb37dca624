"""A small cell for the CPU tests: the syn64_2k configuration cut to 16
antennas, 16 integrations, 4 channels and a 128^2 image, 20 PD
iterations a major."""

from pathlib import Path

import torch

from harness import main

BENCH = Path(__file__).resolve().parents[1]
SEED = 2**31 + 12345


def small_parts(workload="syn64_2k.spotless", pd_maxit=20):
    torch.set_num_threads(2)
    p = main.parts(workload)
    p["cfg"] = dict(p["cfg"], nant=16, ntime=16, nchan=4, nx=128)
    p["traffic"] = dict(p["traffic"], call=dict(p["traffic"]["call"],
                                                pd_maxit=pd_maxit))
    return p

