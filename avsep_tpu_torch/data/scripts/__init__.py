"""Offline data-prep tools (reference ``data/scripts/``), the port's own
copies of ``avsep_tpu/data/scripts/``: audio and frame extraction, TV-L1
optical flow, manifest post-processing, demo video assembly.  Host-side,
off the training path; numpy and the standard library, with cv2 and ffmpeg
used by the functions that need them, never torch."""
