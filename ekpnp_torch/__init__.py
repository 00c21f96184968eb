"""ekpnp_torch: the PyTorch/CUDA port of ekpnp for one NVIDIA H100.

A package of its own beside `ekpnp` (the JAX reference).  It imports
`torch`, never `jax`, and nothing of `ekpnp`.  Every entry point takes an
explicit `device` ("cuda" by default; "cpu" only when asked for).  On the
card the step runs the hand-written kernels of `ekpnp_torch.kernels`.
"""
from .config import Config, GridConfig, PhysicsConfig, RunConfig, from_file, preset

__all__ = ["Config", "GridConfig", "PhysicsConfig", "RunConfig", "from_file",
           "preset"]
__version__ = "0.1.0"
