"""Package metadata (reference ``setup.py:16-32``)."""

import os

from setuptools import find_packages, setup


def read_requirements():
    path = os.path.join(os.path.dirname(__file__), "requirements.txt")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [l.strip() for l in f
                if l.strip() and not l.strip().startswith("#")]


setup(
    name="fleetx-tpu",
    version="0.1.0",
    description="TPU-native large-model training framework "
                "(JAX/XLA/Pallas re-design of PaddleFleetX)",
    packages=find_packages(include=("fleetx_tpu", "fleetx_tpu.*",
                                    "fleetx_tpu_torch",
                                    "fleetx_tpu_torch.*")),
    package_data={"fleetx_tpu": ["configs/**/*.yaml",
                                 "data/native/*.cpp",
                                 "data/native/Makefile"],
                  "fleetx_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=read_requirements(),
)
