"""avsep_tpu_torch.data: the host input pipeline.

Manifest-driven deterministic mixing (reference ``dataset/music.py``),
audio crop and gain (reference ``dataset/base.py``), temporally consistent
frame transforms, batch loaders that ship raw waveforms and uint8 frames,
and the int16 audio wire.  These modules import numpy, scipy, PIL and the
standard library, never torch, so loader worker processes stay light; the
STFT and everything after it run on the device (:mod:`avsep_tpu_torch.
engine`).
"""
