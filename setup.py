from setuptools import find_packages, setup

setup(
    name="pfb_tpu",
    version="0.1.0",
    description=("TPU-native radio-interferometric imaging: the "
                 "pre-conditioned forward-backward deconvolution stack "
                 "in JAX/XLA/Pallas"),
    packages=find_packages(include=["pfb_tpu", "pfb_tpu.*",
                                    "pfb_tpu_torch", "pfb_tpu_torch.*"]),
    package_data={"pfb_tpu.parser": ["*.yaml", "*.yml"],
                  "pfb_tpu.native": ["*.cc"],
                  "pfb_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  "pfb_tpu_torch.parser": ["*.yaml", "*.yml"],
                  "pfb_tpu_torch.native": ["*.cc"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy", "sympy", "click",
                      "pyyaml"],
    entry_points={
        "console_scripts": ["pfb-tpu = pfb_tpu.workers.main:cli",
                            "pfb-tpu-torch = pfb_tpu_torch.workers.main:cli"],
    },
)
