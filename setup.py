from setuptools import find_packages, setup

setup(
    name="shallowspeed_tpu",
    version="0.1.0",
    description="TPU-native distributed-training framework (DP x PP on a JAX mesh)",
    packages=find_packages(
        include=[
            "shallowspeed_tpu",
            "shallowspeed_tpu.*",
            "shallowspeed_tpu_torch",
            "shallowspeed_tpu_torch.*",
        ]
    ),
    # the port's CUDA sources are compiled on first use, on the GPU host
    package_data={"shallowspeed_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    # 0.4.37 is the oldest runtime the compat layer supports
    # (parallel/compat.py maps jax.shard_map/check_vma onto the
    # jax.experimental spelling; multihost probes is_initialized)
    install_requires=["jax>=0.4.37", "numpy"],
)
