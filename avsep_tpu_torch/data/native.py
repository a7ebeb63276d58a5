"""ctypes bindings for the C++ host data path (``native/avsep_host.cpp`` and
``native/avsep_frames.cpp``).

The port's own copy of ``avsep_tpu/data/native.py``: the same C functions
behind the same Python signatures.  ``libavsep_host`` reads wavs (a header
probe and a read-crop of int16 / int24 / int32 / float32 PCM), resamples
(windowed sinc), mixes, gain-clamps and measures silence;
``libavsep_frames`` decodes JPEGs with libjpeg and resizes, crops and flips
them with Pillow's exact bicubic resampling (``frame_pipeline_batch``), one
decode per frame on a pool of threads, with the GIL released.

Each library is compiled from the sources in ``native/`` at its first use,
with the flags of ``native/Makefile`` (``-O3 -march=native -fPIC -shared
-std=c++17``; ``-ljpeg -lpthread`` for the frames library), into
``build/avsep_tpu_torch/native/`` under a name that hashes the source, the
flags and the host CPU (``-march=native`` code runs only where it was
built).  ``native/`` is read and never written: its committed ``.so`` files
are the JAX package's and are never loaded here.

A library that does not build or load leaves every one of its functions
returning None (or False), and :func:`load_error` says why; the callers
(``audio_io``, ``dataset``) then take the Python / PIL route.  The frames
library links the host's libjpeg, which may round differently from
Pillow's: :func:`frames_selfcheck_ok` decodes one JPEG both ways before
``--frame_decode auto`` trusts it.  This module imports no torch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "avsep_tpu_torch", "native")
COMPILER = "g++"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
# library -> (source in native/, link flags)
SOURCES = {"host": ("avsep_host.cpp", ()),
           "frames": ("avsep_frames.cpp", ("-ljpeg", "-lpthread"))}
# decode threads of one frame_pipeline_batch call
FRAME_THREADS = 4

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64, _I64P = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
_INT, _INTP = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
# library -> C function -> (restype, argtypes)
SIGNATURES = {
    "host": {
        "wav_probe": (_INT, [ctypes.c_char_p, _I64P, _I64P]),
        "wav_read_crop": (_INT, [ctypes.c_char_p, _I64, _I64, _F32P, _I64P,
                                 _I64P]),
        "resample_sinc": (None, [_F32P, _I64, ctypes.c_double, _F32P, _I64,
                                 ctypes.c_double]),
        "silence_fraction": (ctypes.c_double, [_F32P, _I64,
                                               ctypes.c_double]),
        "all_zero": (_INT, [_F32P, _I64]),
        "gain_clamp": (None, [_F32P, _I64, ctypes.c_float]),
        "mix_sources": (None, [_F32P, _I64, _I64, _F32P]),
    },
    "frames": {
        "jpeg_probe": (_INT, [ctypes.c_char_p, _INTP, _INTP]),
        "resize_rgb": (_INT, [_U8P, _INT, _INT, _U8P, _INT, _INT, _INT]),
        # paths, n, rw, rh, crop (l, t, w, h), fw, fh, flip, filter, fast,
        # out_h, out_w, out, threads
        "frame_pipeline_batch": (_INT, [ctypes.POINTER(ctypes.c_char_p),
                                        _INT] + [_INT] * 13 + [_U8P, _INT]),
    },
}


# ------------------------------------------------------------------ build


def host_cpu() -> str:
    """The host CPU's model name (``/proc/cpuinfo``), else its machine
    type."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return os.uname().machine


def library_path(name: str) -> str:
    """Where library ``name`` (``host`` or ``frames``) is built."""
    src, link = SOURCES[name]
    h = hashlib.sha256()
    with open(os.path.join(NATIVE_DIR, src), "rb") as f:
        h.update(f.read())
    h.update(" ".join((COMPILER,) + CXXFLAGS + link).encode())
    h.update(host_cpu().encode())
    return os.path.join(BUILD_DIR, f"lib{os.path.splitext(src)[0]}-"
                                   f"{h.hexdigest()[:16]}.so")


def build(*names: str) -> Dict[str, str]:
    """Compile the libraries ``names`` (all by default) that are not built
    yet, one compiler per source, started together.  Returns name -> path;
    raises ``RuntimeError`` with the compiler's output if one fails."""
    names = names or tuple(SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    try:
        for n, so in paths.items():
            if os.path.exists(so):
                continue
            src, link = SOURCES[n]
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [COMPILER, *CXXFLAGS, "-o", tmp,
                   os.path.join(NATIVE_DIR, src), *link]
            try:
                procs[n] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp)
            except OSError as e:
                raise RuntimeError(f"cannot run {COMPILER}: {e}") from e
        failed = []
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate(timeout=300)
            if proc.returncode:
                failed.append(f"{COMPILER} failed on {SOURCES[n][0]}:\n{log}")
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return paths


@functools.lru_cache(maxsize=None)
def _load(name: str) -> Tuple[Optional[ctypes.CDLL], str]:
    """(the loaded library ``name``, "") or (None, why not), built on first
    use and cached for the process."""
    try:
        lib = ctypes.CDLL(build(name)[name])
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        return None, str(e)
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib, ""


def load_error(name: str) -> str:
    """Why library ``name`` is unavailable ("" when it loaded)."""
    return _load(name)[1]


def native_available() -> bool:
    """True when the host library (wav IO, resample, mix) loaded."""
    return _load("host")[0] is not None


def frames_available() -> bool:
    """True when the frames library (libjpeg decode) loaded."""
    return _load("frames")[0] is not None


@functools.lru_cache(maxsize=None)
def frames_selfcheck_ok() -> bool:
    """Whether the frames library decodes, and bicubic-resizes, one
    synthetic JPEG exactly as Pillow does on this host; cached.  A failure
    prints why: ``--frame_decode auto`` then stays on PIL."""
    if not frames_available():
        print(f"[avsep_tpu_torch.native] frames library unavailable "
              f"({load_error('frames')}); auto decodes with PIL")
        return False
    import io

    from PIL import Image
    rs = np.random.RandomState(0)
    img = Image.fromarray(rs.randint(0, 256, (48, 64, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=90)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        path = os.path.join(d, "selfcheck.jpg")
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        with Image.open(path) as im:
            rgb = im.convert("RGB")
            want = np.asarray(rgb)
            want_r = np.asarray(rgb.resize((32, 24), Image.BICUBIC))
        got = frame_pipeline_batch([path], 48, 64, n_threads=1)
        got_r = frame_pipeline_batch([path], 24, 32, resize=(32, 24),
                                     n_threads=1)
    ok = (got is not None and np.array_equal(got[0], want)
          and got_r is not None and np.array_equal(got_r[0], want_r))
    if not ok:
        print("[avsep_tpu_torch.native] frame decode self-check against "
              "PIL FAILED (the host libjpeg differs from Pillow's?); auto "
              "decodes with PIL")
    return ok


# ------------------------------------------------------------------ frames


def jpeg_probe_dims(path: str) -> Optional[Tuple[int, int]]:
    """(width, height) from the JPEG header, or None on any failure."""
    lib = _load("frames")[0]
    if lib is None:
        return None
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.jpeg_probe(path.encode(), ctypes.byref(w), ctypes.byref(h)):
        return None
    return w.value, h.value


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def resize_rgb(img: np.ndarray, oh: int, ow: int,
               filt: str = "bicubic") -> Optional[np.ndarray]:
    """Pillow-exact uint8 RGB resize, or None."""
    lib = _load("frames")[0]
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    ih, iw = img.shape[:2]
    out = np.empty((oh, ow, 3), np.uint8)
    rc = lib.resize_rgb(_u8p(img), ih, iw, _u8p(out), oh, ow,
                        1 if filt == "bicubic" else 0)
    return out if rc == 0 else None


def frame_pipeline_batch(paths, out_h: int, out_w: int, *,
                         resize=None, crop=None, final=None,
                         hflip: bool = False, filt: str = "bicubic",
                         fast: bool = False,
                         n_threads: Optional[int] = None
                         ) -> Optional[np.ndarray]:
    """Decode -> resize to ``resize`` (w, h) -> crop ``(left, top, w, h)``
    -> resize to ``final`` (w, h) -> flip, for every path with the same
    parameters (one draw per clip).  Pillow's pixels bit for bit unless
    ``fast`` (a reduced-scale DCT decode, as ``Image.draft``).  Returns
    ``[len(paths), out_h, out_w, 3]`` uint8, or None on any failure (the
    caller then applies the same parameters with PIL)."""
    lib = _load("frames")[0]
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rw, rh = resize or (0, 0)
    cl, ct, cw, ch = crop or (0, 0, 0, 0)
    fw, fh = final or (0, 0)
    rc = lib.frame_pipeline_batch(
        arr, n, rw, rh, cl, ct, cw, ch, fw, fh, int(hflip),
        1 if filt == "bicubic" else 0, int(fast), out_h, out_w, _u8p(out),
        FRAME_THREADS if n_threads is None else n_threads)
    return out if rc == 0 else None


# ------------------------------------------------------------------- audio


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def wav_probe(path: str) -> Optional[Tuple[int, int]]:
    """(sample_rate, total_frames) from the header alone, or None."""
    lib = _load("host")[0]
    if lib is None:
        return None
    sr, frames = ctypes.c_int64(0), ctypes.c_int64(0)
    if lib.wav_probe(path.encode(), ctypes.byref(sr), ctypes.byref(frames)):
        return None
    return sr.value, frames.value


def wav_read_crop(path: str, start_frame: int, count: int
                  ) -> Optional[Tuple[np.ndarray, int]]:
    """Up to ``count`` mono float32 samples from ``start_frame`` (channels
    averaged) and the sample rate, or None."""
    lib = _load("host")[0]
    if lib is None:
        return None
    out = np.zeros(count, np.float32)
    sr, got = ctypes.c_int64(0), ctypes.c_int64(0)
    if lib.wav_read_crop(path.encode(), start_frame, count, _fptr(out),
                         ctypes.byref(sr), ctypes.byref(got)):
        return None
    return out[: got.value], sr.value


def resample_sinc(x: np.ndarray, sr_in: float, sr_out: float
                  ) -> Optional[np.ndarray]:
    lib = _load("host")[0]
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    out = np.zeros(int(round(len(x) * sr_out / sr_in)), np.float32)
    lib.resample_sinc(_fptr(x), len(x), float(sr_in), _fptr(out), len(out),
                      float(sr_out))
    return out


def silence_fraction(x: np.ndarray, thresh: float) -> Optional[float]:
    lib = _load("host")[0]
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    return float(lib.silence_fraction(_fptr(x), len(x), thresh))


def all_zero(x: np.ndarray) -> Optional[bool]:
    lib = _load("host")[0]
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    return bool(lib.all_zero(_fptr(x), len(x)))


def gain_clamp(x: np.ndarray, gain: float) -> bool:
    """``x = clip(x * gain, -1, 1)`` in place (float32, contiguous); False
    when the library is unavailable."""
    lib = _load("host")[0]
    if lib is None:
        return False
    if x.dtype != np.float32 or not x.flags.c_contiguous:
        raise ValueError("gain_clamp works in place on contiguous float32")
    lib.gain_clamp(_fptr(x), len(x), gain)
    return True


def mix_sources(sources: np.ndarray) -> Optional[np.ndarray]:
    lib = _load("host")[0]
    if lib is None:
        return None
    sources = np.ascontiguousarray(sources, np.float32)
    n_src, n = sources.shape
    out = np.zeros(n, np.float32)
    lib.mix_sources(_fptr(sources), n_src, n, _fptr(out))
    return out
