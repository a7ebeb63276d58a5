"""The port's C++ host path (avsep_tpu_torch/data/native.py) on the CPU:

* each binding against ``avsep_tpu.data.native`` (which imports no JAX) on
  the same inputs, exactly: the wav probe and read-crop (int16, float32 and
  stereo files), the sinc resample, the silence fraction, the zero test,
  the gain clamp, the mix, the JPEG probe, the bicubic resize and the
  fused frame pipeline (exact and ``fast``), and the self-check;
* the dataset's ``native``, ``auto`` and ``pil`` routes bit for bit on
  data/mini, frames and clips, train and val;
* ``native`` and ``fast`` raise, and ``auto`` takes PIL, when the library
  cannot build (the compiler monkeypatched away);
* the build writes under ``build/`` only and leaves ``native/`` as it is
  (its files' mtimes, sizes and ``git status``).
"""

import os
import subprocess
import wave

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.data import native as jnative
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.data import audio_io, native
from avsep_tpu_torch.data.dataset import MusicMixDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "data", "mini", "train.csv")
JPG = os.path.join(REPO, "data", "mini", "frames", "cello", "v00.mp4",
                   "000003.jpg")


def write_wav(path, data, sr, width):
    """A PCM wav of int16 (width 2) samples; ``data`` [n] or [n, ch]."""
    data = np.asarray(data)
    ch = 1 if data.ndim == 1 else data.shape[1]
    pcm = (np.clip(data, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def write_float_wav(path, data, sr):
    """A WAVE_FORMAT_IEEE_FLOAT mono file, which ``wave`` rejects."""
    data = np.asarray(data, "<f4")
    fmt = (np.array([3, 1], "<u2").tobytes() + np.array([sr, sr * 4],
           "<u4").tobytes() + np.array([4, 32], "<u2").tobytes())
    body = (b"WAVE" + b"fmt " + np.uint32(len(fmt)).tobytes() + fmt
            + b"data" + np.uint32(data.nbytes).tobytes() + data.tobytes())
    with open(path, "wb") as f:
        f.write(b"RIFF" + np.uint32(len(body)).tobytes() + body)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rs = np.random.RandomState(0)
    mono, stereo = 0.3 * rs.randn(22050), 0.3 * rs.randn(9000, 2)
    out = {"mono": d / "mono.wav", "stereo": d / "stereo.wav",
           "float": str(d / "float.wav")}
    write_wav(out["mono"], mono, 22050, 2)
    write_wav(out["stereo"], stereo, 16000, 2)
    write_float_wav(out["float"], 0.5 * rs.randn(5000), 11025)
    return {k: str(v) for k, v in out.items()}


def test_libraries_build_and_load():
    assert native.native_available(), native.load_error("host")
    assert native.frames_available(), native.load_error("frames")
    assert native.load_error("host") == native.load_error("frames") == ""
    assert native.frames_selfcheck_ok() == jnative.frames_selfcheck_ok()


def test_audio_bindings_equal_jax(wavs):
    for name, path in wavs.items():
        assert native.wav_probe(path) == jnative.wav_probe(path), name
        for start, count in ((0, 100), (777, 4000), (4990, 100)):
            got, sr = native.wav_read_crop(path, start, count)
            want, jsr = jnative.wav_read_crop(path, start, count)
            assert sr == jsr
            np.testing.assert_array_equal(got, want, err_msg=name)
        # the read through audio_io goes through the C++ reader
        np.testing.assert_array_equal(
            audio_io.read_wav(path, 0.1, 0.2)[0],
            native.wav_read_crop(path, int(0.1 * native.wav_probe(path)[0]),
                                 int(0.2 * native.wav_probe(path)[0]))[0])
    rs = np.random.RandomState(1)
    x = rs.randn(3001).astype(np.float32)
    np.testing.assert_array_equal(native.resample_sinc(x, 22050, 11025),
                                  jnative.resample_sinc(x, 22050, 11025))
    x[::3] = 0.0
    assert native.silence_fraction(x, 0.2) == \
        jnative.silence_fraction(x, 0.2)
    assert native.all_zero(np.zeros(9, np.float32)) is True
    assert native.all_zero(x) is False
    assert bool(jnative._load().all_zero(jnative._fptr(x), len(x))) is False
    a, b = x.copy(), x.copy()
    assert native.gain_clamp(a, 3.5) and jnative.gain_clamp(b, 3.5)
    np.testing.assert_array_equal(a, b)
    src = rs.randn(3, 500).astype(np.float32)
    np.testing.assert_array_equal(native.mix_sources(src),
                                  jnative.mix_sources(src))
    with pytest.raises(ValueError):
        native.gain_clamp(x[::2], 1.0)


def test_frame_bindings_equal_jax():
    assert native.jpeg_probe_dims(JPG) == jnative.jpeg_probe_dims(JPG) \
        == (96, 72)
    assert native.jpeg_probe_dims(MINI) is None
    img = np.random.RandomState(2).randint(0, 256, (37, 53, 3), np.uint8)
    for filt in ("bicubic", "bilinear"):
        np.testing.assert_array_equal(native.resize_rgb(img, 20, 31, filt),
                                      jnative.resize_rgb(img, 20, 31, filt))
    paths = [JPG, JPG.replace("000003", "000004")]
    for kw in (dict(resize=(128, 96), crop=(10, 7, 64, 64), hflip=True),
               dict(resize=(341, 256), crop=(20, 30, 150, 120),
                    final=(64, 64)),
               dict(resize=(341, 256), crop=(58, 16, 224, 224), fast=True)):
        size = 224 if kw.get("fast") else 64
        got = native.frame_pipeline_batch(paths, size, size, **kw)
        want = jnative.frame_pipeline_batch(paths, size, size, **kw)
        assert got.shape == (2, size, size, 3)
        np.testing.assert_array_equal(got, want)
    assert native.frame_pipeline_batch([MINI], 8, 8) is None


def _cfg(**kw):
    return Config(**{**dict(audLen=65535, imgSize=64, num_mix=2,
                            one_frame=True, val_repeat=1, train_repeat=1,
                            rate_dc=1.0, clip_len=8), **kw})


@pytest.mark.parametrize("split,clips", [("val", False), ("train", False),
                                         ("val", True), ("train", True)])
def test_routes_equal_pil_bit_for_bit(split, clips):
    """``native`` and ``auto`` against ``pil`` on every data/mini sample:
    audio, frames, clips, ids."""
    assert native.frames_selfcheck_ok()
    sets = {fd: MusicMixDataset(MINI, _cfg(frame_decode=fd,
                                           load_clips=clips),
                                split=split, seed=4)
            for fd in ("native", "auto", "pil")}
    assert {fd: d.frame_route for fd, d in sets.items()} == {
        "native": "native", "auto": "native", "pil": "pil"}
    for i in range(len(sets["pil"])):
        want = sets["pil"][i]
        for fd in ("native", "auto"):
            got = sets[fd][i]
            assert set(got) == set(want)
            for k, v in want.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
                else:
                    assert got[k] == v, k
    fast = MusicMixDataset(MINI, _cfg(frame_decode="fast", load_clips=clips),
                           split=split, seed=4)
    assert fast.frame_route == "fast"
    item = fast[0]
    assert item["frames"].shape == sets["pil"][0]["frames"].shape
    np.testing.assert_array_equal(item["audios"], sets["pil"][0]["audios"])


@pytest.mark.parametrize("clips", [False, True])
def test_failed_decode_takes_pil_with_the_same_draws(monkeypatch, clips):
    """A clip the C++ decode fails on (a corrupt JPEG mid-clip) after its
    parameters were drawn goes through PIL with those parameters: every
    sample equals the ``pil`` route's, and the draws that follow too."""
    monkeypatch.setattr(native, "frame_pipeline_batch",
                        lambda *a, **kw: None)
    got, want = (MusicMixDataset(MINI, _cfg(frame_decode=fd,
                                            load_clips=clips,
                                            one_frame=False, num_frames=3),
                                 split="train", seed=1)
                 for fd in ("native", "pil"))
    assert got.frame_route == "native"
    for i in range(len(want)):
        a, b = got[i], want[i]
        for k in ("frames", "audios") + (("clips",) if clips else ()):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["id"] == b["id"]


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """The module with a compiler that does not exist and an empty build
    directory; its caches are cleared before and after."""
    monkeypatch.setattr(native, "COMPILER",
                        str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    native._load.cache_clear()
    native.frames_selfcheck_ok.cache_clear()
    yield
    monkeypatch.undo()
    native._load.cache_clear()
    native.frames_selfcheck_ok.cache_clear()


def test_native_raises_when_the_library_cannot_build(no_compiler, capsys):
    assert not native.frames_available() and not native.native_available()
    assert "no-such-compiler" in native.load_error("frames")
    assert native.frame_pipeline_batch([JPG], 8, 8) is None
    assert native.wav_probe(JPG) is None
    for fd in ("native", "fast"):
        with pytest.raises(RuntimeError, match="frames library"):
            MusicMixDataset(MINI, _cfg(frame_decode=fd))
    auto = MusicMixDataset(MINI, _cfg(frame_decode="auto", load_clips=True))
    assert auto.frame_route == "pil"
    assert "auto decodes with PIL" in capsys.readouterr().out
    want = MusicMixDataset(MINI, _cfg(frame_decode="pil", load_clips=True))
    np.testing.assert_array_equal(auto[1]["clips"], want[1]["clips"])
    # the wav reader falls back to the standard library's
    np.testing.assert_array_equal(
        audio_io.read_wav(os.path.join(REPO, "data", "mini", "audio",
                                       "cello", "v00.wav"), 0.5, 0.1)[0],
        jnative_free_read(0.5, 0.1))


def jnative_free_read(offset, duration):
    path = os.path.join(REPO, "data", "mini", "audio", "cello", "v00.wav")
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        w.setpos(int(offset * sr))
        raw = w.readframes(int(duration * sr))
    return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0


def _native_dir_state():
    d = os.path.join(REPO, "native")
    return {f: (os.stat(os.path.join(d, f)).st_mtime_ns,
                os.stat(os.path.join(d, f)).st_size)
            for f in sorted(os.listdir(d))}


def _git_status_native():
    out = subprocess.run(["git", "status", "--porcelain", "--", "native"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=60)
    return out.stdout if out.returncode == 0 else None


def test_build_writes_under_build_only(monkeypatch):
    """A fresh build of both libraries writes into its directory under
    build/ and nowhere in native/."""
    assert native.BUILD_DIR.startswith(os.path.join(REPO, "build") + os.sep)
    for name in native.SOURCES:
        assert os.path.dirname(native.library_path(name)) == native.BUILD_DIR
    fresh = os.path.join(REPO, "build", "avsep_tpu_torch",
                         f"native-test-{os.getpid()}")
    monkeypatch.setattr(native, "BUILD_DIR", fresh)
    before, status = _native_dir_state(), _git_status_native()
    try:
        paths = native.build()
        assert sorted(os.listdir(fresh)) == sorted(
            os.path.basename(p) for p in paths.values())
        assert all(p.startswith(fresh + os.sep) for p in paths.values())
        assert native.build() == paths              # built once
    finally:
        for f in os.listdir(fresh):
            os.remove(os.path.join(fresh, f))
        os.rmdir(fresh)
    assert _native_dir_state() == before
    assert _git_status_native() == status
