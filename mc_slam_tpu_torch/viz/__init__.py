from mc_slam_tpu_torch.viz.snapshot import render_frame_overlay, save_map_snapshot

__all__ = ["save_map_snapshot", "render_frame_overlay"]
