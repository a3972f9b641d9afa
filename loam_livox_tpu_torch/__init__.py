"""PyTorch and CUDA port of loam_livox_tpu: Livox LiDAR odometry and
mapping on an NVIDIA Hopper card.

The JAX package ``loam_livox_tpu`` is the reference this port is held
against; this package imports nothing of it and nothing of JAX.  Entry
points: `OdometryPipeline` and `run_odometry` in `runtime.pipeline`.
"""
from .core.config import SlamConfig
from .runtime.pipeline import OdometryPipeline, run_odometry

__all__ = ["SlamConfig", "OdometryPipeline", "run_odometry"]
