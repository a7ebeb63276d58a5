"""avsep_tpu_torch: the PyTorch and CUDA port of avsep_tpu for NVIDIA Hopper.

Batched audio-visual separation (``engine.separate``), the joint AV/AO
training step (``train``), batched BSS-eval (``evaluate``) and the train /
eval command line (``python -m avsep_tpu_torch.main``), with the STFT head
and the iSTFT tail as hand-written CUDA kernels (``ops/kernels.py``,
``csrc/``).  The package imports torch, numpy, scipy, PIL and the standard
library, and nothing of the JAX package.
"""

from avsep_tpu_torch.config import Config

__all__ = ["Config"]
