"""The port's ``engine.separate`` (avsep_tpu_torch/engine.py) end to end
against ``avsep_tpu.engine.separate``, on the CPU, with the same weights
carried over by avsep_tpu_torch/models/from_jax.py: AV with two streams,
the duet quirk, ``share_blank`` and audio-only with the JAX uniforms
injected.

Size: unet5, resnet18dilated-256 at 64x64 frames, 16383 samples (64 STFT
frames).  The weights are random He-scaled values in the JAX shapes (see
test_torch_models.py), so every layer moves the masks.

Tolerances: with ``binary_mask=0`` the masks are held at 2e-4 absolute (the
U-Net's float32 drift, see test_torch_models.py) and the waveforms at 1e-4
relative to their largest sample (the masks scale the mixture's spectrum,
then an iSTFT that sums four frames per sample).  With ``binary_mask=1`` a
bin whose mask lies within float noise of 0.5 may flip, so the binary masks
must agree on all but 1e-3 of the bins.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.config import Config as JConfig
from avsep_tpu.engine import build_nets as jax_build_nets
from avsep_tpu.engine import separate as jax_separate
from avsep_tpu_torch import engine
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.models.from_jax import load_from_jax
from tests.test_torch_models import random_variables

SMALL = dict(arch_sound="unet5", num_channels=2, vis_channels=256,
             fusion_type="hidsep", att_type="sig", not_pool_vis=False,
             img_activation="relu", output_activation="sigmoid",
             binary_mask=0, weighted_loss=1, log_freq=1, one_frame=True,
             audLen=16383, imgSize=64)


def _configs(**kw):
    kw = {**SMALL, **kw}
    return JConfig(**kw), Config(**kw)


@pytest.fixture(scope="module")
def nets():
    jcfg, cfg = _configs()
    jnets = jax_build_nets(jcfg)
    rs = np.random.RandomState(0)
    sv = random_variables(jnets.sound, rs, jnp.zeros((1, 256, 64, 1)),
                          jnp.zeros((2, 1, 4, 4, 256)), train=False)
    fv = random_variables(jnets.frame, rs, jnp.zeros((1, 64, 64, 3)),
                          pool=False, train=False)
    params = {"sound": sv["params"], "frame": fv["params"]}
    stats = {"sound": sv["batch_stats"], "frame": fv["batch_stats"]}
    pnets = engine.build_nets(cfg, device="cpu")
    load_from_jax(pnets, params, stats)
    return jnets, params, stats, pnets


def _inputs(seed, n_streams=2, B=2):
    rs = np.random.RandomState(seed)
    wav = (rs.randn(B, 16383) * 0.1).astype(np.float32)
    frames = rs.randint(0, 256, (B, n_streams, 1, 64, 64, 3)).astype(
        np.uint8)
    return wav, frames


def _run(nets, wav, frames, share_blank=False, key=None, **cfg_kw):
    jnets, params, stats, pnets = nets
    jcfg, cfg = _configs(**cfg_kw)
    ref = jax.device_get(jax_separate(
        jnets, params, stats, jnp.asarray(wav),
        None if frames is None else jnp.asarray(frames), jcfg, rng=key,
        share_blank=share_blank))
    u = None if key is None else torch.from_numpy(
        np.array(jax.random.uniform(key, (wav.shape[0],))))
    got = engine.separate(pnets, wav, frames, cfg, device="cpu",
                          swap_uniforms=u, share_blank=share_blank)
    return ref, got


def _check(ref, got, B, N):
    assert got["wavs"].shape == (B, N, 16128)
    assert got["masks"].shape == (B, N, 256, 64)
    assert got["masks_linear"].shape == (B, N, 512, 64)
    m, rm = got["masks"].numpy(), np.asarray(ref["masks"])
    assert np.abs(m - rm).max() < 2e-4
    assert m.std() > 0.05                           # the layers moved it
    np.testing.assert_allclose(got["masks_linear"].numpy(),
                               np.asarray(ref["masks_linear"]), atol=2e-4)
    w, rw = got["wavs"].numpy(), np.asarray(ref["wavs"])
    assert np.abs(w - rw).max() < 1e-4 * np.abs(rw).max()
    assert np.isfinite(w).all() and np.abs(w).max() <= 1.0


def test_separate_av_matches_jax(nets):
    wav, frames = _inputs(1)
    ref, got = _run(nets, wav, frames)
    _check(ref, got, 2, 2)
    assert got["att_maps"].shape == (2, 2, 4, 4)
    np.testing.assert_allclose(got["att_maps"].numpy(),
                               np.asarray(ref["att_maps"]), atol=1e-4)


def test_separate_duet_matches_jax(nets):
    """One stream, duplicated, without img_activation."""
    wav, frames = _inputs(2, n_streams=1)
    ref, got = _run(nets, wav, frames)
    _check(ref, got, 2, 2)


def test_separate_share_blank_matches_jax(nets):
    wav, frames = _inputs(3)
    ref, got = _run(nets, wav, frames, share_blank=True)
    _check(ref, got, 2, 2)


def test_separate_audio_only_matches_jax_with_injected_uniforms(nets):
    wav, _ = _inputs(4)
    ref, got = _run(nets, wav, None, key=jax.random.PRNGKey(5))
    _check(ref, got, 2, 2)
    assert got["att_maps"] is None


def test_separate_binary_masks_agree_with_jax(nets):
    wav, frames = _inputs(6)
    ref, got = _run(nets, wav, frames, binary_mask=1)
    lin = got["masks_linear"].numpy()
    assert set(np.unique(lin)) <= {0.0, 1.0}
    assert np.mean(lin != np.asarray(ref["masks_linear"])) < 1e-3
    assert np.abs(got["masks"].numpy()
                  - np.asarray(ref["masks"])).max() < 2e-4


def test_separate_takes_float_frames_as_normalized(nets):
    """Float frames pass through normalize_frames unchanged."""
    wav, frames = _inputs(7)
    normed = engine.normalize_frames(torch.from_numpy(frames)).numpy()
    ref, got = _run(nets, wav, normed)
    _check(ref, got, 2, 2)


def test_audio_only_needs_a_draw(nets):
    wav, _ = _inputs(8)
    _, cfg = _configs()
    with pytest.raises(ValueError):
        engine.separate(nets[3], wav, None, cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    out = engine.separate(nets[3], wav, None, cfg, device="cpu", generator=g)
    assert out["wavs"].shape == (2, 2, 16128)


def test_entry_points_do_not_fall_back_to_the_cpu(monkeypatch):
    """Without a GPU and without device='cpu', every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.build_nets(cfg)
    nets = engine.build_nets(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.init_params(cfg, nets, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.separate(nets, np.zeros((1, 16383), np.float32), None, cfg)


def test_init_params_is_seeded_and_follows_the_reference_init():
    _, cfg = _configs()
    a = engine.init_params(cfg, engine.build_nets(cfg, device="cpu"),
                           torch.Generator().manual_seed(3), device="cpu")
    b = engine.init_params(cfg, engine.build_nets(cfg, device="cpu"),
                           torch.Generator().manual_seed(3), device="cpu")
    for x, y in zip(a.sound.state_dict().values(),
                    b.sound.state_dict().values()):
        assert torch.equal(x, y)
    w = a.sound.down1.conv.weight
    assert abs(w.std().item() - 0.001) < 1e-4
    assert (a.frame.features.bn1.weight == 1).all()
    assert not a.sound.training and not a.frame.training


def test_build_nets_rejects_what_this_slice_leaves_out():
    """The motion branch is ported: ``load_clips`` builds the motion net,
    ``fusion_type CoLoc_ClipAtt`` without it raises ``ValueError`` as the
    JAX package's ``build_nets`` does."""
    _, cfg = _configs()
    engine.build_nets(cfg.replace(fusion_type="MixVis"), device="cpu")
    assert engine.build_nets(cfg, device="cpu").motion is None
    nets = engine.build_nets(cfg.replace(load_clips=True), device="cpu")
    assert nets.motion is not None and not nets.motion.training
    with pytest.raises(ValueError, match="load_clips"):
        engine.build_nets(cfg.replace(fusion_type="CoLoc_ClipAtt"),
                          device="cpu")
    with pytest.raises(ValueError, match="load_clips"):
        jax_build_nets(_configs(fusion_type="CoLoc_ClipAtt")[0])


def test_separate_mixvis_one_stream_matches_jax(nets):
    """MixVis with one (mixture) stream: not the duet quirk, the activated
    feature goes to the fusion once (avsep_tpu/engine.py:431)."""
    jnets, params, stats, _ = nets
    jcfg, cfg = _configs(fusion_type="MixVis")
    jn = jax_build_nets(jcfg)._replace(frame=jnets.frame)
    pn = engine.build_nets(cfg, device="cpu")
    load_from_jax(pn, params, stats)
    wav, frames = _inputs(9, n_streams=1)
    ref = jax.device_get(jax_separate(jn, params, stats, jnp.asarray(wav),
                                      jnp.asarray(frames), jcfg))
    got = engine.separate(pn, wav, frames, cfg, device="cpu")
    _check(ref, got, 2, 2)


@pytest.mark.slow
def test_separate_flagship_matches_jax():
    """The flagship of bench.py at full width: unet7, resnet18dilated-256
    at 224x224, 65535 samples (B = 1)."""
    kw = dict(arch_sound="unet7", audLen=65535, imgSize=224, dft="matmul")
    jcfg, cfg = _configs(**kw)
    jnets = jax_build_nets(jcfg)
    rs = np.random.RandomState(0)
    sv = random_variables(jnets.sound, rs, jnp.zeros((1, 256, 256, 1)),
                          jnp.zeros((2, 1, 14, 14, 256)), train=False)
    fv = random_variables(jnets.frame, rs, jnp.zeros((1, 224, 224, 3)),
                          pool=False, train=False)
    params = {"sound": sv["params"], "frame": fv["params"]}
    stats = {"sound": sv["batch_stats"], "frame": fv["batch_stats"]}
    pnets = engine.build_nets(cfg, device="cpu")
    load_from_jax(pnets, params, stats)
    wav = (rs.randn(1, 65535) * 0.1).astype(np.float32)
    frames = rs.randint(0, 256, (1, 2, 1, 224, 224, 3)).astype(np.uint8)
    ref = jax.device_get(jax_separate(jnets, params, stats,
                                      jnp.asarray(wav), jnp.asarray(frames),
                                      jcfg))
    got = engine.separate(pnets, wav, frames, cfg, device="cpu")
    assert got["wavs"].shape == (1, 2, 65280)
    assert got["att_maps"].shape == (1, 2, 14, 14)
    assert np.abs(got["masks"].numpy()
                  - np.asarray(ref["masks"])).max() < 5e-4
    rw = np.asarray(ref["wavs"])
    assert np.abs(got["wavs"].numpy() - rw).max() < 2e-4 * np.abs(rw).max()
