"""biped_pympc_tpu_torch — the batched biped MPC of `biped_pympc_tpu` in
PyTorch, with its PDIPM as a hand-written CUDA kernel for NVIDIA Hopper.

Each module names its twin in the JAX package, which stays the reference.
This package imports torch and numpy, never jax.
"""

from biped_pympc_tpu_torch.config import ControllerConf, MPCConf, recommended_conf
from biped_pympc_tpu_torch.wrapper import MPCController

__all__ = ["MPCController", "MPCConf", "ControllerConf", "recommended_conf"]
__version__ = "0.1.0"
