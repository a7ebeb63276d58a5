"""The port's host data pipeline (avsep_tpu_torch/data/) against the JAX
package's (avsep_tpu/data/) on the synthetic manifest of
tests/test_dataset.py: every ``__getitem__`` bit for bit (audios, mixture,
uint8 frames, ids, classes, infos) for ``train`` and ``val``, the loaders'
batch order, and the int16 wire's arrays.  Both datasets decode frames
with PIL (``frame_decode pil``) and with their C++ decode where that builds
(``auto``, which each checks against PIL before use; the port's routes are
held against each other in tests/test_torch_native.py).  Also: the data modules import in a process where ``torch`` cannot
be imported, so the loaders' worker processes stay light."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.config import Config as JConfig
from avsep_tpu.data import dataset as jds
from avsep_tpu.data import loader as jloader
from avsep_tpu.data.wire import encode_audio_wire as jencode
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.data import dataset as pds
from avsep_tpu_torch.data import loader as ploader
from avsep_tpu_torch.data.wire import encode_audio_wire
from tests.test_dataset import AUDLEN, SR, manifest  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(audLen=AUDLEN, audRate=SR, imgSize=48, num_frames=3,
            stride_frames=2, one_frame=False, margin=1.0, train_repeat=2,
            val_repeat=2, rate_dc=1.0, num_mix=2, max_silent=0.9)


def configs(**kw):
    kw = {**BASE, **kw}
    return JConfig(**kw), Config(**kw)


def assert_samples_equal(a, b):
    assert set(a) == set(b)
    for k, v in a.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype and v.shape == b[k].shape, k
            np.testing.assert_array_equal(v, b[k], err_msg=k)
        else:
            assert v == b[k], k


@pytest.mark.parametrize("split,jax_decode,kw", [
    ("train", "pil", {}),
    ("val", "pil", {}),
    ("train", "auto", dict(one_frame=True)),
    ("val", "auto", dict(rate_dc=0.0, rate_sc=1.0)),
    ("val", "pil", dict(load_clips=True, clip_len=4, one_frame=True)),
])
def test_dataset_equals_jax_bit_for_bit(manifest, split, jax_decode, kw):  # noqa: F811
    jcfg, cfg = configs(**kw)
    jcfg = dataclasses.replace(jcfg, frame_decode=jax_decode)
    want = jds.MusicMixDataset(manifest, jcfg, split=split, seed=3)
    got = pds.MusicMixDataset(manifest, cfg, split=split, seed=3)
    assert len(got) == len(want)
    assert got.list_samples == want.list_samples
    for i in range(len(got)):
        assert_samples_equal(got[i], want[i])


def test_random_sample_and_vis1_options_equal_jax(manifest):  # noqa: F811
    jcfg, cfg = configs()
    for kw in (dict(random_sample=True), dict(vis_data="vis1")):
        want = jds.MusicMixDataset(manifest, jcfg, split="val", **kw)
        got = pds.MusicMixDataset(manifest, cfg, split="val", **kw)
        for i in (0, 5):
            assert_samples_equal(got[i], want[i])


def test_read_manifest_and_unported_decode(manifest):  # noqa: F811
    """Every decode the JAX package takes is ported: ``native`` and
    ``fast`` take the C++ route where its library loads (the JAX dataset's
    ``native`` samples bit for bit), and an unknown decode raises."""
    assert pds.read_manifest(manifest) == jds.read_manifest(manifest)
    jcfg, cfg = configs()
    for fd in ("native", "fast"):
        ds = pds.MusicMixDataset(manifest, cfg.replace(frame_decode=fd))
        assert ds.frame_route == fd
    want = jds.MusicMixDataset(
        manifest, dataclasses.replace(jcfg, frame_decode="native"))
    got = pds.MusicMixDataset(manifest, cfg.replace(frame_decode="native"))
    assert_samples_equal(got[1], want[1])
    with pytest.raises(ValueError, match="frame_decode"):
        pds.MusicMixDataset(manifest, cfg.replace(frame_decode="cv2"))


def test_loaders_yield_jax_batches_in_order(manifest):  # noqa: F811
    """The thread and process loaders over a ConcatDataset of two seeds,
    shuffled, with a ragged last batch: the JAX thread loader's batches,
    in its order, bit for bit; then drop_last."""
    jcfg, cfg = configs()
    jcat = jloader.ConcatDataset([
        jds.MusicMixDataset(manifest, jcfg, split="val"),
        jds.MusicMixDataset(manifest, jcfg, split="val", seed=10)])
    pcat = ploader.ConcatDataset([
        pds.MusicMixDataset(manifest, cfg, split="val"),
        pds.MusicMixDataset(manifest, cfg, split="val", seed=10)])
    assert len(pcat) == len(jcat) == 24
    want = list(jloader.BatchLoader(jcat, 5, shuffle=True, num_workers=2,
                                    seed=1))
    threads = list(ploader.BatchLoader(pcat, 5, shuffle=True, num_workers=3,
                                       seed=1))
    procs = ploader.ProcessBatchLoader(pcat, 5, shuffle=True, num_workers=2,
                                       seed=1)
    try:
        got = list(procs)
        again = list(procs)          # a second epoch reshuffles
    finally:
        procs.close()
    assert len(want) == len(threads) == len(got) == 5
    for a, b, c in zip(want, threads, got):
        assert_samples_equal(b, a)
        assert_samples_equal(c, a)
    assert [b["id"] for b in again] != [b["id"] for b in got]
    dropped = ploader.BatchLoader(pcat, 5, shuffle=False, num_workers=2,
                                  drop_last=True)
    assert len(dropped) == 4
    assert [len(b["id"]) for b in dropped] == [5] * 4


def test_iter_forever_and_prefetcher_order(manifest):  # noqa: F811
    _, cfg = configs()
    ds = pds.MusicMixDataset(manifest, cfg, split="val")
    loader = ploader.BatchLoader(ds, 4, shuffle=False, num_workers=2)
    epoch = [b["id"] for b in loader]
    it = ploader.iter_forever(loader)
    assert [next(it)["id"] for _ in range(2 * len(epoch))] == epoch * 2
    pf = ploader.DevicePrefetcher(iter(loader), lambda b: b["id"], depth=2)
    assert list(pf) == epoch
    pf.close()


@pytest.mark.parametrize("wire", ["f32", "int16"])
def test_encode_audio_wire_equals_jax(wire):
    rs = np.random.RandomState(4)
    audios = (rs.randn(3, 2, 1000) * 0.2).astype(np.float32)
    audios[1, 0] = 0.0                    # a silent source
    batch = {"audios": audios, "frames": np.zeros((3, 2), np.uint8)}
    jcfg, cfg = configs(audio_wire=wire)
    got, want = encode_audio_wire(batch, cfg), jencode(batch, jcfg)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    if wire == "int16":
        assert "audios" not in got and got["audios_i16"].dtype == np.int16
        assert not got["audios_i16"][1, 0].any()
    with pytest.raises(ValueError, match="audio_wire"):
        encode_audio_wire(batch, cfg.replace(audio_wire="bf16"))


_PROBE = """
import sys
sys.modules["torch"] = None           # any import of torch raises
import importlib
for mod in sys.argv[1:]:
    importlib.import_module(mod)
assert "torch" not in [m for m in sys.modules if sys.modules[m] is not None]
print("ok")
"""


def test_data_modules_import_without_torch():
    mods = ["avsep_tpu_torch.config", "avsep_tpu_torch.data.audio_io",
            "avsep_tpu_torch.data.video_transforms",
            "avsep_tpu_torch.data.dataset", "avsep_tpu_torch.data.loader",
            "avsep_tpu_torch.data.wire", "avsep_tpu_torch.data.native",
            "avsep_tpu_torch.main",
            "avsep_tpu_torch.utils.meters",
            "avsep_tpu_torch.utils.media", "avsep_tpu_torch.utils.viz",
            "avsep_tpu_torch.check_exp", "avsep_tpu_torch.sop_main"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, *mods], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
