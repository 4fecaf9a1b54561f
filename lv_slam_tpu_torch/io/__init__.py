"""Host-side data for the port: the synthetic LiDAR workload and the KITTI
devkit error metric (numpy only)."""
