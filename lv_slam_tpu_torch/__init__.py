"""lv_slam_tpu_torch — the PyTorch + CUDA port of lv_slam_tpu.

The JAX package `lv_slam_tpu` is the reference; this package mirrors its
subpackage layout (`core/`, `ops/`, `odometry/`, `io/`) so every module's
counterpart is easy to find. Plain tensor code is PyTorch; the hot ops that
the reference shaped by hand for the TPU are hand-written CUDA kernels for
Hopper (`csrc/`, built at first use by `kernels/_build.py`). Each kernel's
wrapper runs its plain PyTorch twin for CPU tensors, which is what the CPU
parity tests compare against the JAX functions.

The port imports nothing of `jax` or of the reference package.
"""

__version__ = "0.1.0"

from lv_slam_tpu_torch.config import (  # noqa: F401
    LfaConfig,
    NDTConfig,
    OdometryConfig,
    PipelineConfig,
    PrefilterConfig,
    kitti_flagship_config,
)
