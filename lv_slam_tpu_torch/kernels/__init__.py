"""Hand-written CUDA kernels: the loader and the launch counts.

`KERNELS` maps each kernel's name to its `Kernel` (C entry points, the JAX
function it replaces, its source file and its `launches` count). The
kernels register themselves when their wrapper module is imported.
"""

from lv_slam_tpu_torch.kernels._build import KERNELS, LIBRARY, Kernel, reset_launches  # noqa: F401
