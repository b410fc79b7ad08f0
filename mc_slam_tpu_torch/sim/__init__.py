"""Synthetic data: textured-room renderer and analytic MAV trajectories."""
from mc_slam_tpu_torch.sim.room import RoomWorld, make_texture
from mc_slam_tpu_torch.sim.trajectory import MavTrajectory

__all__ = ["RoomWorld", "MavTrajectory", "make_texture"]
