"""The port's separation CLI (avsep_tpu_torch/separate_cli.py) against
``avsep_tpu.separate_cli`` on the CPU: the loaders bit for bit, and
``main(argv, device="cpu")`` end to end against the JAX CLI's wavs on the
repository's duet clips (data/mini).

Both CLIs hard-code the flagship config; the end-to-end case shrinks it in
both packages alike (unet5, 64x64 frames, 16383 samples, soft masks so
that no bin sits on the threshold) and gives both the same random weights:
the JAX CLI through its ``init_state``, the port through a checkpoint
(``--ckpt``) written from them.  Tolerance: the written PCM-16 wavs within
1e-4 of their largest sample (tests/test_torch_engine.py's) plus one
quantization step.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
import avsep_tpu.separate_cli as jcli
from avsep_tpu.config import Config as JConfig
from avsep_tpu.data.audio_io import write_wav as jwrite_wav
from avsep_tpu_torch import checkpoint, engine, separate_cli, train
from avsep_tpu_torch.data.audio_io import read_wav
from avsep_tpu_torch.models.from_jax import load_from_jax
from tests.test_dataset import make_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUET = os.path.join(REPO, "data", "mini", "audio_duet", "cello flute")
FRAMES = os.path.join(REPO, "data", "mini", "frames_duet", "cello flute")
SMALL = dict(arch_sound="unet5", audLen=16383, imgSize=64, binary_mask=0)


def test_load_mixture_is_the_jax_loaders(tmp_path):
    cfg = make_cfg()
    x = (np.sin(np.arange(5000) / 10) * 2).astype(np.float32)
    p = str(tmp_path / "m.wav")
    jwrite_wav(p, x, cfg.audRate)
    out = separate_cli.load_mixture(p, cfg)
    assert out.shape == (cfg.audLen,) and np.abs(out).max() <= 1.0
    np.testing.assert_array_equal(out, jcli.load_mixture(p, cfg))
    duet = os.path.join(DUET, "d00.wav")
    np.testing.assert_array_equal(separate_cli.load_mixture(duet, cfg),
                                  jcli.load_mixture(duet, cfg))


def test_load_frame_dir_is_the_jax_loaders(tmp_path):
    from PIL import Image
    cfg = make_cfg()
    d = tmp_path / "f"
    os.makedirs(d)
    Image.fromarray(np.random.RandomState(0).randint(
        0, 256, (50, 60, 3), np.uint8)).save(d / "000001.jpg")
    for fdir in (str(d), os.path.join(FRAMES, "d00.mp4")):
        out = separate_cli.load_frame_dir(fdir, cfg)
        assert out.shape == (2, 1, cfg.imgSize, cfg.imgSize, 3)
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, jcli.load_frame_dir(fdir, cfg))
    assert separate_cli.load_frame_dir(None, cfg) is None
    assert separate_cli.load_frame_dir(str(tmp_path), cfg) is None


@pytest.fixture(scope="module")
def weights():
    """Random JAX weights of the shrunk flagship."""
    from avsep_tpu.engine import build_nets
    from tests.test_torch_models import random_variables
    import jax.numpy as jnp
    jcfg = JConfig(**{**_flagship_kw(), **SMALL})
    jnets = build_nets(jcfg)
    rs = np.random.RandomState(0)
    sv = random_variables(jnets.sound, rs, jnp.zeros((1, 256, 64, 1)),
                          jnp.zeros((2, 1, 4, 4, 256)), train=False)
    fv = random_variables(jnets.frame, rs, jnp.zeros((1, 64, 64, 3)),
                          pool=False, train=False)
    return ({"sound": sv["params"], "frame": fv["params"]},
            {"sound": sv["batch_stats"], "frame": fv["batch_stats"]})


def _flagship_kw():
    from avsep_tpu_torch.config import FLAGSHIP
    keys = ("arch_sound", "num_channels", "vis_channels", "fusion_type",
            "att_type", "not_pool_vis", "img_activation",
            "output_activation", "binary_mask", "log_freq", "one_frame")
    return {k: getattr(FLAGSHIP, k) for k in keys}


def test_main_writes_the_jax_clis_wavs(weights, tmp_path, monkeypatch):
    params, stats = weights
    inputs = [os.path.join(DUET, f) for f in ("d00.wav", "d01.wav")]
    frames = [os.path.join(FRAMES, f) for f in ("d00.mp4", "d01.mp4")]
    argv = ["--inputs", *inputs, "--frames", *frames]

    # the JAX CLI, shrunk, on these weights
    monkeypatch.setattr(jcli, "Config",
                        lambda **kw: JConfig(**{**kw, **SMALL}))
    monkeypatch.setattr(jcli, "init_state", lambda *a, **k:
                        types.SimpleNamespace(params=params,
                                              batch_stats=stats))
    monkeypatch.setattr(sys, "argv", ["separate_cli", *argv, "--out_dir",
                                      str(tmp_path / "jax")])
    jcli.main()

    # the port's, shrunk alike, from a checkpoint of the same weights
    cfg = separate_cli.FLAGSHIP.replace(**SMALL)
    monkeypatch.setattr(separate_cli, "FLAGSHIP", cfg)
    state = train.init_state(cfg, engine.build_nets(cfg, device="cpu"),
                             torch.Generator().manual_seed(0), device="cpu")
    load_from_jax(state.nets, params, stats)
    checkpoint.save_checkpoint(str(tmp_path / "ckpt" / "run"), state, {},
                               "best")
    separate_cli.main(argv + ["--out_dir", str(tmp_path / "port"),
                              "--ckpt", str(tmp_path / "ckpt"),
                              "--id", "run"], device="cpu")
    for stem in ("d00", "d01"):
        for n in (1, 2):
            name = f"{stem}_src{n}.wav"
            got, sr = read_wav(str(tmp_path / "port" / name))
            want, _ = read_wav(str(tmp_path / "jax" / name))
            assert sr == 11025 and got.shape == want.shape == (16128,)
            assert np.abs(got - want).max() <= \
                1e-4 * np.abs(want).max() + 1.0 / 32767, name
            assert np.abs(want).max() > 1e-3, name      # not silence

    # audio-only: no frames, the swap from a seeded generator
    separate_cli.main(["--inputs", *inputs, "--out_dir",
                       str(tmp_path / "ao")], device="cpu")
    outs = sorted(os.listdir(tmp_path / "ao"))
    assert outs == ["d00_src1.wav", "d00_src2.wav", "d01_src1.wav",
                    "d01_src2.wav"]


def test_main_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        separate_cli.main(["--inputs", os.path.join(DUET, "d00.wav")])
