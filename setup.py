from setuptools import find_packages, setup

setup(
    name="ntlink-tpu",
    version="0.1.0",
    description="TPU-native long-read genome scaffolding (JAX/XLA/Pallas)",
    packages=find_packages(include=[
        "ntlink_tpu", "ntlink_tpu.*", "ntlink_tpu_torch", "ntlink_tpu_torch.*",
    ]),
    package_data={
        "ntlink_tpu.native": ["*.c"],
        "ntlink_tpu_torch": ["csrc/*.cu"],
        "ntlink_tpu_torch.native": ["*.c"],
    },
    python_requires=">=3.10",
    install_requires=["numpy"],
    extras_require={"tpu": ["jax"], "torch": ["torch"]},
    entry_points={"console_scripts": ["ntlink=ntlink_tpu.cli:main"]},
)
