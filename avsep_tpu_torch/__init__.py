"""avsep_tpu_torch: the PyTorch and CUDA port of avsep_tpu for NVIDIA Hopper.

Batched audio-visual separation (``engine.separate``) with the STFT head and
the iSTFT tail as hand-written CUDA kernels (``ops/kernels.py``,
``csrc/``).  The package imports torch, numpy and the standard library, and
nothing of the JAX package.
"""

from avsep_tpu_torch.config import Config

__all__ = ["Config"]
