from lv_slam_tpu_torch.lfa.pipeline import LfaPipeline  # noqa: F401
