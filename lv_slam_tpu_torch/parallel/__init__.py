"""Several sequences on one card (`fleet`) and registration across ranks
(`mesh`, over `torch.distributed`): the port of `lv_slam_tpu.parallel`."""

from lv_slam_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    ndt_align_sharded,
    ndt_derivatives_sharded,
)
