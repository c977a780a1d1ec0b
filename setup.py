"""pip-installable packaging (reference setup.py builds fcos_core + the
`fcos` CLI; here the native C++ component builds lazily via ctypes at first
import, so no build_ext is needed)."""

from setuptools import find_packages, setup

setup(
    name="scan-tpu",
    version="0.1.0",
    description=(
        "TPU-native cross-domain object detection with Semantic Conditioned "
        "Adaptation (JAX/XLA/Pallas rebuild of CityU-AIM-Group/SCAN)"
    ),
    packages=find_packages(include=["scan_tpu", "scan_tpu.*",
                                    "scan_tpu_torch", "scan_tpu_torch.*"]),
    package_data={"scan_tpu.native": ["*.cpp"],
                  "scan_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy",
                      "pyyaml", "pillow"],
    entry_points={
        "console_scripts": [
            "scan-tpu=scan_tpu.cli:main",
        ]
    },
)
