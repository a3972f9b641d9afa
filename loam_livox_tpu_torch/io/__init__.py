from . import simulator
from .simulator import BoxScene, LivoxSimulator, RosettePattern, SimConfig, Trajectory

__all__ = [
    "simulator", "BoxScene", "LivoxSimulator", "RosettePattern", "SimConfig",
    "Trajectory",
]
