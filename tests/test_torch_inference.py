"""The port's demos (avsep_tpu_torch/inference.py) against
``avsep_tpu.inference`` on the CPU, on the synthetic manifest
(tests/test_dataset.py: 12 s clips at 5 fps, so a 6 s window has 30 display
frames) with noise added to its sines, with the same weights
(``from_jax``).  The noise keeps every spectrogram bin well above float32
rounding: on a pure tone most bins hold rounding noise of the FFT, whose
log differs between the two FFT libraries, and the masks there differed
by up to 0.38 (the wavs, which those bins hardly carry, by 1.2e-4).

* ``get_demo_audio``, ``load_display_frames`` and ``attention_overlay``:
  bit for bit.
* vis / share / synthesis / sweep (with ``duet_vis_rate``): the written
  wavs, and the uint8 arrays handed to the image writer and to the video
  writer (the JAX package writes with imageio, the port with PIL; the
  encoded bytes are not compared).  Size as tests/test_serve.py (unet5 at
  ngf 8, the dilated ResNet18-32 on 64x64 frames, 16383 samples), soft
  masks so that no bin sits on the threshold.
* pixelwise: the SoP++ nets at unet5 (ngf 64) and resnet18dilated-8 on
  64x64 frames; the raw energy map and the per-pixel masks against the
  JAX demo's.

Tolerances: wavs within 1e-4 of their largest sample (as
tests/test_torch_engine.py) plus one PCM-16 step; mask images within 1 of
255 (a float32 value within rounding of a quantization step may land on
either side: masks agree to 2e-4); the attention maps handed to the
overlay within 1e-4, as tests/test_torch_engine.py (read 5.8e-5); the
spectrogram heatmap bit for bit on all but 1e-3 of its pixels; the
pixelwise energy map within 1 of 255 after normalization, its float16
masks within 1e-3.
"""

import os
import types

import imageio
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
import avsep_tpu.inference as jinf
import avsep_tpu.sop_main as jsop_main
from avsep_tpu.data.dataset import read_manifest
from avsep_tpu_torch import checkpoint, inference, sop_main
from avsep_tpu_torch.data.audio_io import read_wav
from avsep_tpu_torch.models.from_jax import load_sop_from_jax
from tests.test_dataset import manifest  # noqa: F401 (fixture)
from tests.test_torch_forward import configs, make_nets
from tests.test_torch_models import random_variables


JAX_OVERLAY, PORT_OVERLAY = jinf.attention_overlay, inference.attention_overlay


@pytest.fixture(scope="module")
def noisy(manifest, tmp_path_factory):  # noqa: F811
    """The synthetic manifest with 0.05 of white noise on each sine."""
    from avsep_tpu.data.audio_io import read_wav as jread_wav
    from avsep_tpu.data.audio_io import write_wav as jwrite_wav
    root = tmp_path_factory.mktemp("noisy")
    rs = np.random.RandomState(0)
    lines = []
    for i, row in enumerate(read_manifest(manifest)):
        wav, sr = jread_wav(row[0])
        path = str(root / f"clip{i}.wav")
        jwrite_wav(path, wav + 0.05 * rs.randn(len(wav)).astype(np.float32),
                   sr)
        lines.append(",".join([path] + row[1:]) + "\n")
    csv_path = root / "noisy.csv"
    csv_path.write_text("".join(lines))
    return str(csv_path)


@pytest.fixture(scope="module")
def noisy_1fps(noisy, tmp_path_factory):
    """``noisy`` read at 1 fps: 6 display frames per window."""
    rows = read_manifest(noisy)
    path = tmp_path_factory.mktemp("fps1") / "noisy_1fps.csv"
    path.write_text("".join(",".join(r[:2] + ["12", "1.0"] + r[4:]) + "\n"
                            for r in rows))
    return str(path)


@pytest.fixture(scope="module")
def model():
    # duet_vis_rate is read by duet_sweep only; one config object lets
    # the sweep reuse the JAX demo's compiled vis program
    jcfg, cfg = configs(arch_frame="resnet18dilated", binary_mask=0,
                        duet_vis_rate=0.5)
    jnets, params, stats, pnets = make_nets(cfg)
    return (jcfg, jnets, params, stats), (cfg, pnets)


class Writers:
    """Captures what each package hands to its image and video writers,
    keyed by file name under the save folder, and the attention maps it
    hands to ``attention_overlay``."""

    def __init__(self, monkeypatch, root):
        self.images, self.videos, self.att = {}, {}, []
        self.root = root

        def key(path):
            return os.path.relpath(path, self.root)

        def jax_imwrite(path, image, *a, **k):
            self.images[key(path)] = np.asarray(image).copy()

        def port_imwrite(path, image):
            self.images[key(path)] = np.asarray(image).copy()
            inference.Image.fromarray(np.ascontiguousarray(image)).save(path)

        def video(path, frames, fps=25):
            self.videos[key(path)] = np.asarray(frames).copy()

        def overlay(fn):
            def wrapped(frame, att):
                self.att.append(np.asarray(att).copy())
                return fn(frame, att)
            return wrapped

        monkeypatch.setattr(imageio, "imwrite", jax_imwrite)
        monkeypatch.setattr(inference, "_imwrite", port_imwrite)
        for mod, fn in ((jinf, JAX_OVERLAY), (inference, PORT_OVERLAY)):
            monkeypatch.setattr(mod, "attention_overlay", overlay(fn))
            monkeypatch.setattr(mod, "save_video", video)
            monkeypatch.setattr(mod, "combine_video_audio",
                                lambda *a, **k: None)


def run_both(monkeypatch, tmp_path, jax_fn, port_fn):
    """Runs each demo into its own folder; returns the two Writers."""
    out = []
    for name, fn in (("jax", jax_fn), ("port", port_fn)):
        w = Writers(monkeypatch, str(tmp_path / name))
        fn(str(tmp_path / name))
        out.append(w)
    return out


def check_wavs(tmp_path, names):
    for name in names:
        got, _ = read_wav(str(tmp_path / "port" / name))
        want, _ = read_wav(str(tmp_path / "jax" / name))
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= \
            1e-4 * np.abs(want).max() + 1.0 / 32767, name


def check_images(jw, pw, heatmaps=()):
    assert set(pw.images) == set(jw.images)
    for k, want in jw.images.items():
        got = pw.images[k]
        assert got.dtype == want.dtype == np.uint8 and \
            got.shape == want.shape, k
        diff = np.abs(got.astype(int) - want.astype(int))
        if os.path.basename(k) in heatmaps:
            assert np.mean(diff > 0) < 1e-3, k
        else:
            assert diff.max() <= 1, k
    # the overlays: the same function (bit for bit, see
    # test_demo_inputs_are_the_jax_packages) of the same frames and of
    # attention maps within 1e-4; each map is stretched to [0, 1] before
    # the colormap, so the overlays themselves may differ by more
    assert set(pw.videos) == set(jw.videos)
    for k, want in jw.videos.items():
        assert pw.videos[k].shape == want.shape, k
    assert len(pw.att) == len(jw.att)
    if pw.att:
        diff = np.abs(np.stack(pw.att) - np.stack(jw.att))
        assert diff.max() < 1e-4, diff.max()


def test_demo_inputs_are_the_jax_packages(manifest):  # noqa: F811
    _, cfg = configs(arch_frame="resnet18dilated")
    rows = read_manifest(manifest)
    a_path, fdir, num_f, fps, a_len = rows[0][:5]
    for seed in (8, 9):
        wav, c_t = inference.get_demo_audio(a_path, num_f, float(fps), a_len,
                                            cfg, seed=seed)
        jwav, jc_t = jinf.get_demo_audio(a_path, num_f, float(fps), a_len,
                                         cfg, seed=seed)
        assert c_t == jc_t
        np.testing.assert_array_equal(wav, jwav)
    frames = inference.load_display_frames(fdir, c_t, float(fps), cfg)
    jframes = jinf.load_display_frames(fdir, c_t, float(fps), cfg)
    assert len(frames) == len(jframes) == 30
    for f, jf in zip(frames, jframes):
        assert f.dtype == np.float32
        np.testing.assert_array_equal(f, jf)
    att = np.random.RandomState(1).rand(4, 4).astype(np.float32)
    over = inference.attention_overlay(frames[0], att)
    assert over.shape == (64, 64, 3) and over.dtype == np.uint8
    np.testing.assert_array_equal(over, jinf.attention_overlay(jframes[0],
                                                               att))


def test_vis_video_matches_jax(model, noisy, tmp_path, monkeypatch):
    """The 30 display frames in one separate() call: the same wavs, masks
    and overlays as the JAX demo's."""
    (jcfg, jnets, params, stats), (cfg, pnets) = model
    row = read_manifest(noisy)[0]
    jw, pw = run_both(
        monkeypatch, tmp_path,
        lambda d: jinf.vis_video(jcfg, jnets, params, stats, row, d),
        lambda d: inference.vis_video(cfg, pnets, row, d, device="cpu"))
    check_wavs(tmp_path, ("pred1.wav", "pred2.wav", "mix.wav"))
    check_images(jw, pw, heatmaps=("mix.jpg",))
    assert set(pw.images) == {"predmask1.jpg", "predmask2.jpg", "mix.jpg"}
    assert set(pw.videos) == {"att1.mp4", "att2.mp4"}
    assert pw.videos["att1.mp4"].shape == (30, 64, 64, 3)


def test_share_and_synthesis_match_jax(model, noisy, tmp_path,
                                       monkeypatch):
    (jcfg, jnets, params, stats), (cfg, pnets) = model
    rows = read_manifest(noisy)
    jw, pw = run_both(
        monkeypatch, tmp_path / "share",
        lambda d: jinf.share_demo(jcfg, jnets, params, stats, rows[0], d),
        lambda d: inference.share_demo(cfg, pnets, rows[0], d,
                                       device="cpu"))
    check_wavs(tmp_path / "share", ("pred1.wav", "pred2.wav", "mix.wav"))
    check_images(jw, pw)
    assert set(pw.images) == {"predmask1.jpg", "predmask2.jpg"}
    run_both(
        monkeypatch, tmp_path / "syn",
        lambda d: jinf.synthesis_demo(jcfg, jnets, params, stats, rows[0],
                                      rows[2], d),
        lambda d: inference.synthesis_demo(cfg, pnets, rows[0], rows[2], d,
                                           device="cpu"))
    check_wavs(tmp_path / "syn", ("mix.wav", "pred1.wav", "pred2.wav",
                                  "gt1.wav", "gt2.wav"))


def test_duet_sweep_vis_rate_matches_jax(model, noisy,
                                         tmp_path, monkeypatch):
    """``--duet_vis_rate 0.5``: wavs and masks for every row, attention
    videos for rows 0 and 2 only, in both packages."""
    (jcfg, jnets, params, stats), (cfg, pnets) = model
    rows = read_manifest(noisy)[:3]
    jw, pw = run_both(
        monkeypatch, tmp_path,
        lambda d: jinf.duet_sweep(jcfg, jnets, params, stats, rows, d),
        lambda d: inference.duet_sweep(cfg, pnets, rows, d, device="cpu"))
    check_wavs(tmp_path, [f"duet_{i}/pred{n}.wav" for i in range(3)
                          for n in (1, 2)])
    check_images(jw, pw, heatmaps=("mix.jpg",))
    assert {os.path.dirname(k) for k in pw.videos} == {"duet_0", "duet_2"}


@pytest.fixture(scope="module")
def sop_weights():
    """Random JAX weights of the SoP++ nets of ``pix_configs``."""
    jcfg, _ = pix_configs()
    jnets = jsop_main.build_sop_nets(jcfg)
    rs = np.random.RandomState(0)
    sv = random_variables(jnets.sound, rs, jnp.zeros((1, 256, 64, 1)),
                          train=False)
    fv = random_variables(jnets.frame, rs, jnp.zeros((1, 1, 64, 64, 3)),
                          pool=False, train=False)
    syn = {"scale": (1 + 0.1 * rs.randn(8)).astype(np.float32),
           "bias": np.float32([0.1])}
    return ({"sound": sv["params"], "frame": fv["params"],
             "synthesizer": syn},
            {"sound": sv["batch_stats"], "frame": fv["batch_stats"]})


def pix_configs(**kw):
    return configs(arch_frame="resnet18dilated", num_channels=8,
                   vis_channels=8, img_activation="relu", att_type="sig",
                   id="pix", **kw)


def test_pixelwise_matches_jax(sop_weights, noisy, tmp_path,
                               monkeypatch, capsys):
    """The JAX demo on ``sop_weights`` (through its ``init_sop_state``),
    the port's restoring them from its ``best`` checkpoint."""
    params, stats = sop_weights
    jcfg, cfg = pix_configs(ckpt=str(tmp_path / "ckpt"))
    row = read_manifest(noisy)[0]
    monkeypatch.setattr(jsop_main, "init_sop_state", lambda *a, **k:
                        types.SimpleNamespace(params=params,
                                              batch_stats=stats))
    state = sop_main.init_sop_state(
        cfg, sop_main.build_sop_nets(cfg, device="cpu"),
        torch.Generator().manual_seed(0), device="cpu")
    load_sop_from_jax(state.nets, params, stats)
    run_dir = str(tmp_path / "ckpt" / "pix")
    checkpoint.save_checkpoint(run_dir, state, {}, "best")
    jw, pw = run_both(
        monkeypatch, tmp_path,
        lambda d: jinf.pixelwise_demo(jcfg, row, d),
        lambda d: inference.pixelwise_demo(cfg, row, d, device="cpu"))
    assert "WARNING" not in capsys.readouterr().out
    assert set(pw.images) == set(jw.images) == {"sound_map.jpg",
                                                "sound_map_raw.jpg"}
    raw = [w.images["sound_map_raw.jpg"].astype(int) for w in (jw, pw)]
    assert raw[0].shape == (4, 4) and raw[0].max() == 255
    assert np.abs(raw[0] - raw[1]).max() <= 1
    masks = [np.load(str(tmp_path / d / "pixel_masks.npy")).astype(
        np.float32) for d in ("jax", "port")]
    assert masks[1].shape == (4, 4, 256, 64)
    assert np.abs(masks[0] - masks[1]).max() < 1e-3

    # no best: the latest, restored when load_ckpt asks; none: a warning
    os.rename(os.path.join(run_dir, "state_best.pt"),
              os.path.join(run_dir, "state_latest.pt"))
    loaded = cfg.replace(load_ckpt="1")
    inference.pixelwise_demo(loaded, row, str(tmp_path / "latest"),
                             device="cpu")
    assert "WARNING" not in capsys.readouterr().out
    np.testing.assert_array_equal(
        np.load(str(tmp_path / "latest" / "pixel_masks.npy")),
        np.load(str(tmp_path / "port" / "pixel_masks.npy")))
    os.remove(os.path.join(run_dir, "state_latest.pt"))
    inference.pixelwise_demo(loaded, row, str(tmp_path / "none"),
                             device="cpu")
    assert "WARNING: no checkpoint found" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="vis_channels"):
        inference.pixelwise_demo(cfg.replace(vis_channels=4), row,
                                 str(tmp_path), device="cpu")


@pytest.mark.parametrize("mode", ["vis", "share", "sweep", "synthesis",
                                  "pixelwise"])
def test_main_runs_every_demo_mode(noisy_1fps, tmp_path, mode):
    """``main(cfg, device="cpu")`` in each mode, at unet5 / 64x64 / 16383
    samples with the builders' nets (ngf 64), on the manifest read at 1 fps
    (6 display frames)."""
    noisy = noisy_1fps
    _, cfg = configs(arch_frame="resnet18dilated", vis_channels=256,
                     demo_mode=mode, list_val=(noisy,), id="demo",
                     ckpt=str(tmp_path), duet_vis_rate=1.0)
    if mode == "pixelwise":
        cfg = cfg.replace(num_channels=8, vis_channels=8)
    if mode == "sweep":                   # two rows are enough
        two = tmp_path / "two.csv"
        with open(noisy) as f:
            two.write_text("".join(f.readlines()[:2]))
        cfg = cfg.replace(list_val=(str(two),))
    inference.main(cfg, device="cpu")
    root = tmp_path / "demo" / "demo"
    clip = os.path.basename(read_manifest(noisy)[0][0]).split(".")[0]
    want = {"vis": f"{clip}/pred1.wav", "share": f"share_{clip}/pred2.wav",
            "sweep": "duet_1/pred1.wav", "synthesis": "synthesis/gt2.wav",
            "pixelwise": "pixelwise/sound_map.jpg"}[mode]
    assert os.path.exists(root / want)


def test_main_rejects_an_unknown_mode_and_needs_a_gpu(manifest,  # noqa: F811
                                                      monkeypatch):
    _, cfg = configs(demo_mode="nope", list_val=(manifest,))
    with pytest.raises(SystemExit, match="demo_mode"):
        inference.main(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.main(cfg.replace(demo_mode="vis"))
