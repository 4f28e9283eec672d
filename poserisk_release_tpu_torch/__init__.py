"""PoseRisk in PyTorch for NVIDIA Hopper: the port of the JAX package.

The same pipeline as the JAX package (video -> detection/tracking -> SPIN ->
joint angles -> REBA/RULA scores -> reports), written in PyTorch, with every
TPU (Pallas) kernel on its path rewritten by hand for the H100 in CUDA C++
(csrc/). It imports neither jax nor the JAX package. Entry points run on
CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from poserisk_release_tpu_torch.config import Config, default_config  # noqa: F401
