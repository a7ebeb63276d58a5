"""The port's host-only leftovers against the JAX package's, on the CPU.

``avsep_tpu_torch/data/scripts/`` (manifests, wav and frame extraction,
optical flow, the flow demo video), ``data.dataset.MusicAODataset``,
``data.video_transforms.pad_img`` and ``utils.viz.HTMLVisualizer``.  The
manifests are held byte for byte against the JAX script's on the tree that
``examples/make_synthetic_data.py --layout reference`` writes (the tree of
tests/test_dataset.py's ``test_post_process_csv_emit_splits``); the flow
jpgs byte for byte against the JAX ``process_dir`` on the same frames; the
rest equal.  What runs ffmpeg skips where there is none, deciding inside
the test.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.config import Config as JConfig
from avsep_tpu.data import dataset as jds
from avsep_tpu.data import video_transforms as jvt
from avsep_tpu.data.scripts import extract_wav as jextract_wav
from avsep_tpu.utils.viz import HTMLVisualizer as JHTMLVisualizer
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.data import dataset as pds
from avsep_tpu_torch.data import video_transforms as pvt
from avsep_tpu_torch.data.scripts import extract_wav
from avsep_tpu_torch.utils.viz import HTMLVisualizer
from tests.test_dataset import AUDLEN, SR, manifest  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(*argv):
    r = subprocess.run([sys.executable, *argv], capture_output=True,
                       text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def need_ffmpeg():
    if shutil.which("ffmpeg") is None:
        pytest.skip("ffmpeg is not installed")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The reference-layout tree of tests/test_dataset.py's manifest test."""
    root = tmp_path_factory.mktemp("tree")
    run(os.path.join(REPO, "examples", "make_synthetic_data.py"),
        "--root", str(root), "--layout", "reference", "--classes", "cello",
        "flute", "--videos_per_class", "2", "--duets", "1", "--duration",
        "0.6", "--fps", "3", "--img_size", "24", "32")
    return root


@pytest.mark.parametrize("args", [
    ["--emit_splits", "--val_per_class", "1"],
    ["--emit_splits", "--val_per_class", "0", "--fps", "3"],
    ["--audio_root", "{root}/audio", "--frames_root", "{root}/frames"]])
def test_post_process_csv_byte_equal_to_jax(tree, tmp_path, args):
    outs = {}
    for pkg in ("avsep_tpu", "avsep_tpu_torch"):
        out = tmp_path / pkg
        argv = [a.format(root=tree) for a in args]
        if "--emit_splits" in args:
            argv += ["--root", str(tree), "--out_dir", str(out)]
        else:
            os.makedirs(out)
            argv += ["--out", str(out / "all.csv")]
        run("-m", f"{pkg}.data.scripts.post_process_csv", *argv)
        outs[pkg] = {f: (out / f).read_bytes()
                     for f in sorted(os.listdir(out))}
    want = outs["avsep_tpu"]
    assert outs["avsep_tpu_torch"] == want
    if "--emit_splits" in args:
        assert set(want) == {f"{n}.csv" for n in
                             ("train", "val", "train_av", "train_ao", "duet")}
    assert want.get("train.csv", want.get("all.csv"))


def _frames(root, name, shifts):
    rs = np.random.default_rng(0)
    texture = rs.integers(0, 255, (40, 40), np.uint8)
    d = root / "frames" / "violin" / name
    d.mkdir(parents=True)
    for i, shift in enumerate(shifts, start=1):
        img = np.full((96, 96), 30, np.uint8)
        img[28:68, 20 + shift:60 + shift] = texture
        Image.fromarray(np.stack([img] * 3, -1)).save(d / f"{i:06d}.jpg")
    return d


@pytest.mark.parametrize("shifts", [(0, 4, 7), (0,)])
def test_extract_optflow_process_dir_equals_jax(tmp_path, shifts):
    """The flow jpgs of a moving patch (and none for a single frame), byte
    for byte, and ``flow_to_u8``."""
    pytest.importorskip("cv2")
    from avsep_tpu.data.scripts import extract_optflow as jflow
    from avsep_tpu_torch.data.scripts import extract_optflow as pflow
    outs = []
    for pkg, mod in (("jax", jflow), ("port", pflow)):
        d = _frames(tmp_path / pkg, "vid0", shifts)
        assert mod.process_dir((str(d), 15.0)) == str(d)
        opt = tmp_path / pkg / "optical" / "violin" / "vid0"
        outs.append({f: (opt / f).read_bytes()
                     for f in sorted(os.listdir(opt))})
    assert outs[0] == outs[1]
    assert len(outs[0]) == 2 * (len(shifts) - 1)
    comp = np.linspace(-20, 20, 64, dtype=np.float32).reshape(8, 8)
    np.testing.assert_array_equal(pflow.flow_to_u8(comp, 15.0),
                                  jflow.flow_to_u8(comp, 15.0))


@pytest.mark.parametrize("path", [
    "data/videos/solo/cello/a.mp4", "/x/videos/duet/cello flute/b.mp4",
    "other/c.mp4"])
def test_extract_wav_paths_equal_jax(path):
    assert extract_wav.audio_out_path(path) == \
        jextract_wav.audio_out_path(path)
    assert extract_wav.frames_out_dir(path) == \
        jextract_wav.frames_out_dir(path)


def test_extract_wav_equals_jax(tmp_path):
    """Both scripts over one synthetic video: the same wav and frames."""
    need_ffmpeg()
    outs = []
    for pkg in ("avsep_tpu", "avsep_tpu_torch"):
        src = tmp_path / pkg / "videos" / "solo" / "cello"
        src.mkdir(parents=True)
        subprocess.run(["ffmpeg", "-y", "-loglevel", "quiet", "-f", "lavfi",
                        "-i", "testsrc=duration=1:size=64x48:rate=4", "-f",
                        "lavfi", "-i", "sine=frequency=440:duration=1",
                        "-shortest", str(src / "v.mp4")], check=True)
        run("-m", f"{pkg}.data.scripts.extract_wav", "--video_root",
            str(tmp_path / pkg / "videos"), "--frames")
        root = tmp_path / pkg
        outs.append({str(p.relative_to(root)): p.read_bytes()
                     for p in root.rglob("*") if p.is_file()
                     and "videos" not in p.parts})
    assert outs[0] == outs[1] and outs[0]


def test_make_optical_video_without_pairs_says_so(tmp_path):
    d = _frames(tmp_path, "vid0", (0, 4))
    said = [run("-m", f"{pkg}.data.scripts.make_optical_video",
                "--frames_dir", str(d), "--out", str(tmp_path / "o.mp4"))
            for pkg in ("avsep_tpu", "avsep_tpu_torch")]
    assert said[0] == said[1] == "no frame/flow pairs found\n"


def test_make_optical_video_equals_jax(tmp_path):
    need_ffmpeg()
    pytest.importorskip("cv2")
    from avsep_tpu_torch.data.scripts import extract_optflow
    d = _frames(tmp_path, "vid0", (0, 4, 7))
    extract_optflow.process_dir((str(d), 15.0))
    videos = []
    for pkg in ("avsep_tpu", "avsep_tpu_torch"):
        out = tmp_path / f"{pkg}.mp4"
        said = run("-m", f"{pkg}.data.scripts.make_optical_video",
                   "--frames_dir", str(d), "--out", str(out))
        assert "(2 frames)" in said
        videos.append(out.read_bytes())
    assert videos[0] == videos[1]


@pytest.mark.parametrize("size,pad,wh", [
    (64, 4, (40, 30)), (32, 2, (40, 50)), (48, 8, (50, 20))])
def test_pad_img_equals_jax(size, pad, wh):
    rs = np.random.RandomState(1)
    frames = [Image.fromarray(rs.randint(0, 255, wh[::-1] + (3,),
                                         dtype=np.uint8)) for _ in range(2)]
    got, want = pvt.pad_img(frames, pad, size), jvt.pad_img(frames, pad, size)
    for g, w in zip(got, want):
        assert g.size == w.size
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("split", ["train", "val"])
def test_music_ao_dataset_equals_jax(manifest, split):  # noqa: F811
    kw = dict(audLen=AUDLEN, audRate=SR, imgSize=48, num_frames=3,
              stride_frames=2, margin=1.0, train_repeat=1, val_repeat=1,
              rate_dc=1.0, num_mix=2, max_silent=0.9, frame_decode="pil")
    got = pds.MusicAODataset(manifest, Config(**kw), split=split, seed=10)
    want = jds.MusicAODataset(manifest, JConfig(**kw), split=split, seed=10)
    assert len(got) == len(want)
    for i in (0, len(want) - 1):
        a, b = got[i], want[i]
        assert set(a) == set(b)
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, b[k], err_msg=k)
            else:
                assert v == b[k], k


def test_html_visualizer_equals_jax(tmp_path):
    rows = [[{"text": "mix"}, {"image": "a.jpg"}, {"audio": "a.wav"}],
            [{"text": "pred", "video": "v.mp4"}, {}, {"image": "b.jpg",
                                                     "audio": "b.wav"}]]
    pages = []
    for cls in (JHTMLVisualizer, HTMLVisualizer):
        path = tmp_path / f"{cls.__module__}.html"
        vis = cls(str(path))
        vis.add_header(["a", "b", "c"])
        vis.add_rows(rows)
        vis.add_row([{"text": "last"}])
        vis.write_html()
        pages.append(path.read_text())
    assert pages[0] == pages[1] and pages[0].endswith("</table>")
