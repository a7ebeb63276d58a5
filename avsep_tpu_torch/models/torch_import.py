"""Load the reference's PyTorch ``.pth`` checkpoints into the port's nets.

Port of ``avsep_tpu/models/torch_import.py``.  The reference saves per-net
``state_dict`` files (``{sound,frame}_{latest,best}.pth``, reference
``main.py:506-533``); their tensors are already in torch's layout, so the
conversion only renames keys onto the port's module names:

* U-Net (``models/audio_net.py:10-43``): the outermost down conv is
  ``unet_block.down_forward.0``; deeper levels nest under
  ``mid_forward.`` with the conv at ``down_forward.1`` and the BN at
  ``down_forward.2``; every up conv is ``up_forward.2`` and its BN
  ``up_forward.3``.
* ResNet: the reference's ``features.N...`` (``vision_net.py:26-30``) or a
  raw torchvision ``resnet18`` dict (``conv1.weight``...); a 4-D ``fc`` is
  the reference's 3x3 projection, a 2-D one torchvision's classifier
  (dropped).
* Motion net: an mmaction SlowFast fast pathway (``conv1.conv``,
  ``conv1.bn``, ``layer{i}.{j}.conv{k}.conv`` / ``.bn``,
  ``layer{i}.{j}.downsample.conv`` / ``.bn``), its keys raw
  (``backbone.fast_path.``), stripped of ``backbone.`` (``fast_path.``)
  or bare; ``cls_head`` and ``slow_path`` are dropped (reference
  models/__init__.py:114-117).  For ``--arch_motion slowfast_r50`` the
  ``slow_path`` is kept (the same names, plus ``conv1_lateral.conv`` and
  ``layer{1,2,3}_lateral.conv``) and both pathways land under
  ``fast_path.`` and ``slow_path.``; the projection ``fc``, which no
  mmaction checkpoint has, is taken where the dict holds one.
* SoP++ synthesizer (``models/synthesizer_net.py:6-70``): ``scale`` (for
  ``InnerProd``) and ``bias`` under their own names.  The SoP++ basis
  U-Net (``SoP++/audio_net.py``) has the U-Net's keys.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _bn(out: Dict, dst: str, sd: Mapping, src: str) -> None:
    for k in _BN_KEYS:
        out[f"{dst}.{k}"] = sd[f"{src}.{k}"]
    # a scalar, as BatchNorm keeps it (the JAX package's export writes it
    # with shape [1])
    out[f"{dst}.num_batches_tracked"] = torch.as_tensor(sd.get(
        f"{src}.num_batches_tracked", 0), dtype=torch.long).reshape(())


def unet_state_dict_from_torch(sd: Mapping, num_downs: int = 7
                               ) -> Dict[str, torch.Tensor]:
    """A reference ``Unet.state_dict()`` -> the ``state_dict`` of the
    port's :class:`~avsep_tpu_torch.models.unet.AudioUnet`."""
    out: Dict[str, torch.Tensor] = {}
    _bn(out, "bn0.bn", sd, "bn0")
    for d in range(num_downs):
        prefix = "unet_block." + "mid_forward." * d
        out[f"down{d}.conv.weight"] = sd[prefix + (
            "down_forward.0.weight" if d == 0 else "down_forward.1.weight")]
        if 0 < d < num_downs - 1:
            _bn(out, f"down_bn{d}.bn", sd, prefix + "down_forward.2")
        out[f"up{d}.conv.weight"] = sd[prefix + "up_forward.2.weight"]
        if prefix + "up_forward.2.bias" in sd:
            out[f"up{d}.conv.bias"] = sd[prefix + "up_forward.2.bias"]
        if d > 0:
            _bn(out, f"up_bn{d}.bn", sd, prefix + "up_forward.3")
    return out


_RESNET_SEQ = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
               "6": "layer3", "7": "layer4"}


def _normalize_resnet_keys(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Reference ``features.N...`` keys -> torchvision's names."""
    out = {}
    for k, v in sd.items():
        if k.startswith("features."):
            parts = k.split(".")
            parts[1] = _RESNET_SEQ.get(parts[1], parts[1])
            out[".".join(parts[1:])] = v
        else:
            out[k] = v
    return out


def resnet_state_dict_from_torch(sd: Mapping, with_fc: bool = True
                                 ) -> Dict[str, torch.Tensor]:
    """A reference ``ResnetFC`` / ``ResnetDilated`` ``state_dict`` or a
    torchvision resnet18 one -> the port's
    :class:`~avsep_tpu_torch.models.resnet.FrameEncoder` keys.  Without a
    4-D ``fc`` the result has no ``fc.*`` keys."""
    sd = _normalize_resnet_keys(sd)
    out: Dict[str, torch.Tensor] = {
        "features.conv1.weight": sd["conv1.weight"]}
    _bn(out, "features.bn1", sd, "bn1")
    for li in (1, 2, 3, 4):
        for bi in (0, 1):
            src, dst = f"layer{li}.{bi}", f"features.layer{li}_{bi}"
            out[dst + ".conv1.weight"] = sd[src + ".conv1.weight"]
            out[dst + ".conv2.weight"] = sd[src + ".conv2.weight"]
            _bn(out, dst + ".bn1", sd, src + ".bn1")
            _bn(out, dst + ".bn2", sd, src + ".bn2")
            if src + ".downsample.0.weight" in sd:
                out[dst + ".downsample_conv.weight"] = sd[
                    src + ".downsample.0.weight"]
                _bn(out, dst + ".downsample_bn", sd, src + ".downsample.1")
    if with_fc and "fc.weight" in sd and sd["fc.weight"].dim() == 4:
        out["fc.weight"] = sd["fc.weight"]
        out["fc.bias"] = sd["fc.bias"]
    return out


def _pathway(out: Dict, dst: str, sd: Mapping, blocks) -> None:
    """One mmaction ResNet3d pathway's stem and stages from ``sd`` (keys
    without the pathway's prefix) into ``out`` under ``dst``."""
    out[dst + "conv1.weight"] = sd["conv1.conv.weight"]
    _bn(out, dst + "bn1", sd, "conv1.bn")
    for li, n_blocks in enumerate(blocks):
        for bi in range(n_blocks):
            src, to = f"layer{li + 1}.{bi}", f"{dst}layer{li + 1}_{bi}"
            for ci in (1, 2, 3):
                out[f"{to}.conv{ci}.weight"] = sd[
                    f"{src}.conv{ci}.conv.weight"]
                _bn(out, f"{to}.bn{ci}", sd, f"{src}.conv{ci}.bn")
            if f"{src}.downsample.conv.weight" in sd:
                out[f"{to}.downsample_conv.weight"] = sd[
                    f"{src}.downsample.conv.weight"]
                _bn(out, f"{to}.downsample_bn", sd, f"{src}.downsample.bn")


def motion_state_dict_from_torch(sd: Mapping, arch: str = "slowfast_fast"
                                 ) -> Dict[str, torch.Tensor]:
    """An mmaction SlowFast ``state_dict``, in any of its three key
    layouts, -> the port's motion net's keys: for ``slowfast_fast`` the
    fast pathway alone, as
    :class:`~avsep_tpu_torch.models.motion.ResNet3dFastOnly` names it (the
    JAX package's ``motion_from_torch``); for ``slowfast_r50`` both
    pathways with the laterals, as
    :class:`~avsep_tpu_torch.models.motion.ResNet3dSlowFast` names them,
    and its ``fc`` where ``sd`` has one."""
    if arch not in ("slowfast_fast", "slowfast_r50"):
        raise ValueError(f"--arch_motion {arch!r}: slowfast_fast or "
                         "slowfast_r50")
    # keys by pathway, without ``backbone.`` and the pathway's prefix; a
    # fast-only dict may come bare
    paths: Dict[str, Dict] = {"fast_path.": {}, "slow_path.": {}, "": {}}
    for k, v in sd.items():
        if "cls_head" in k:
            continue
        if k.startswith("backbone."):
            k = k[len("backbone."):]
        pre = next(p for p in paths if k.startswith(p))
        paths[pre][k[len(pre):]] = v
    blocks = (3, 4, 6, 3)
    out: Dict[str, torch.Tensor] = {}
    if arch == "slowfast_fast":
        _pathway(out, "", paths["fast_path."] or paths[""], blocks)
        return out
    _pathway(out, "fast_path.", paths["fast_path."], blocks)
    slow = paths["slow_path."]
    _pathway(out, "slow_path.", slow, blocks)
    for name in ("conv1_lateral", "layer1_lateral", "layer2_lateral",
                 "layer3_lateral"):
        out[f"slow_path.{name}.weight"] = slow[f"{name}.conv.weight"]
    for k in ("fc.weight", "fc.bias"):
        if k in paths[""]:
            out[k] = paths[""][k]
    return out
    if arch != "slowfast_r50":
        raise ValueError(f"--arch_motion {arch!r}: slowfast_fast or "
                         "slowfast_r50")
    paths: Dict[str, Dict] = {"fast_path.": {}, "slow_path.": {}, "": {}}
    for k, v in sd.items():
        if "cls_head" in k:
            continue
        if k.startswith("backbone."):
            k = k[len("backbone."):]
        pre = next(p for p in paths if k.startswith(p))
        paths[pre][k[len(pre):]] = v
    out = {}
    _pathway(out, "fast_path.", paths["fast_path."], blocks)
    slow = paths["slow_path."]
    _pathway(out, "slow_path.", slow, blocks)
    for name in ("conv1_lateral", "layer1_lateral", "layer2_lateral",
                 "layer3_lateral"):
        out[f"slow_path.{name}.weight"] = slow[f"{name}.conv.weight"]
    for k in ("fc.weight", "fc.bias"):
        if k in paths[""]:
            out[k] = paths[""][k]
    return out


def synthesizer_state_dict_from_torch(sd: Mapping
                                      ) -> Dict[str, torch.Tensor]:
    """A reference ``InnerProd`` / ``Bias`` ``state_dict`` -> the port's
    :mod:`~avsep_tpu_torch.models.synthesizer` keys."""
    out = {"bias": sd["bias"]}
    if "scale" in sd:
        out["scale"] = sd["scale"]
    return out


def load_torch_checkpoint(path: str) -> Mapping[str, torch.Tensor]:
    """A ``.pth`` ``state_dict``, on the CPU, tensors only."""
    return torch.load(path, map_location="cpu", weights_only=True)
