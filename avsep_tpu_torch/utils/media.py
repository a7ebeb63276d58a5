"""Media IO: spectrogram heatmaps, ffmpeg video writing and muxing.

The port's own copy of ``avsep_tpu/utils/media.py`` (reference
``utils.py:29-216``), off the device path (eval visualization only).  cv2
is imported by the function that uses it; ffmpeg runs as a watchdogged
subprocess like the reference, and its absence skips the video with a
warning.
"""

from __future__ import annotations

import os
import shutil
import subprocess as sp
from threading import Timer

import numpy as np


def makedirs(path: str, remove: bool = False) -> None:
    if os.path.isdir(path):
        if remove:
            shutil.rmtree(path)
            print("removed existing directory...")
        else:
            return
    os.makedirs(path)


def magnitude2heatmap(mag: np.ndarray, log: bool = True,
                      scale: float = 200.0) -> np.ndarray:
    """log10 + JET colormap (reference utils.py:90-98)."""
    import cv2
    m = np.asarray(mag, np.float64)
    if log:
        m = np.log10(m + 1.0)
    m = m * scale
    m = np.clip(m, 0, 255).astype(np.uint8)
    color = cv2.applyColorMap(m, cv2.COLORMAP_JET)
    return color[:, :, ::-1]  # BGR -> RGB


def _have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


class VideoWriter:
    """ffmpeg rawvideo pipe writer (reference utils.py:107-168); a no-op
    with a warning when ffmpeg is not installed."""

    def __init__(self, filename: str, fps: float, shape):
        if not filename.endswith(".mp4"):
            raise RuntimeError("Video codec not supported.")
        self.shape = shape
        self.pipe = None
        if not _have_ffmpeg():
            print(f"[media] ffmpeg not found; skipping video {filename}")
            return
        cmd = ["ffmpeg", "-y", "-f", "rawvideo",
               "-s", f"{shape[1]}x{shape[0]}", "-pix_fmt", "bgr24",
               "-r", str(fps), "-i", "-", "-an", "-vcodec", "h264",
               "-pix_fmt", "yuv420p", filename]
        self.pipe = sp.Popen(cmd, stdin=sp.PIPE, stderr=sp.DEVNULL,
                             bufsize=10 ** 8)

    def add_frame(self, frame: np.ndarray):
        assert frame.shape[:2] == tuple(self.shape)
        if self.pipe is None:
            return
        try:
            self.pipe.stdin.write(frame.tobytes())
        except OSError as e:  # ffmpeg exited early; the video is lost
            print(f"[media] ffmpeg pipe closed: {e}")
            self.pipe = None

    def release(self):
        if self.pipe is None:
            return
        self.pipe.stdin.close()
        try:
            self.pipe.wait(timeout=10)
        except sp.TimeoutExpired:
            self.pipe.kill()
            self.pipe.wait()


def save_video(path: str, tensor: np.ndarray, fps: float = 25) -> None:
    """4-D [T, H, W, C] uint8 -> mp4 (reference utils.py:206-215); frames
    given RGB, written BGR."""
    assert tensor.ndim == 4
    writer = VideoWriter(path, fps=fps, shape=list(tensor.shape[1:3]))
    for t in range(tensor.shape[0]):
        writer.add_frame(tensor[t][:, :, ::-1].copy())
    writer.release()


def _run_with_timeout(proc, timeout_sec: float) -> None:
    """10 s ffmpeg watchdog (reference utils.py:171-183)."""
    timer = Timer(timeout_sec, lambda: proc.kill())
    try:
        timer.start()
        proc.communicate()
    finally:
        timer.cancel()


def combine_video_audio(src_video: str, src_audio: str, dst_video: str,
                        verbose: bool = False) -> None:
    """Mux mp4 + wav -> mp4/aac (reference utils.py:186-202)."""
    if not _have_ffmpeg():
        return
    cmd = ["ffmpeg", "-y", "-loglevel", "quiet", "-i", src_video,
           "-i", src_audio, "-c:v", "copy", "-c:a", "aac",
           "-strict", "experimental", dst_video]
    _run_with_timeout(sp.Popen(cmd), 10.0)
    if verbose:
        print(f"Processed:{dst_video}")
