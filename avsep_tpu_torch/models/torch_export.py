"""Export the port's nets to the reference's PyTorch ``state_dict`` keys.

Port of ``avsep_tpu/models/torch_export.py``, and the inverse of
:mod:`avsep_tpu_torch.models.torch_import`: a model trained on the port
goes back to the reference codebase's eval and demo tooling as its per-net
files ``{sound,frame,synthesizer}_{latest,best}.pth`` (reference
``main.py:506-533`` and ``:789-793``).

The port's tensors are already in torch's layout, so the export only
renames keys: the port's module names (the JAX package's parameter paths,
``down3.conv.weight``, ``features.layer4_0.bn1.running_var``...) become the
reference's (``unet_block.mid_forward.mid_forward.mid_forward.down_forward.1
.weight``, ``features.7.0.bn1.running_var``...).  Every BatchNorm carries
its ``num_batches_tracked``, which the reference's strict
``load_state_dict`` asks for.

A port checkpoint (``checkpoint.save_checkpoint``: ``state_{tag}.pt``)
holds each net's ``state_dict`` under ``"sound"``, ``"frame"`` and, for
SoP++, ``"synthesizer"``; ``README.md`` shows the calls.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

_BN_KEYS = ("weight", "bias", "running_mean", "running_var",
            "num_batches_tracked")


def _bn(out: Dict, dst: str, sd: Mapping, src: str) -> None:
    for k in _BN_KEYS:
        out[f"{dst}.{k}"] = sd[f"{src}.{k}"]


def unet_to_torch(sd: Mapping, num_downs: int = 7
                  ) -> Dict[str, torch.Tensor]:
    """An ``AudioUnet`` / ``BasisUnet`` ``state_dict`` -> the reference's
    ``Unet.state_dict()`` keys (models/audio_net.py:10-43; the layer
    indices are :func:`torch_import.unet_state_dict_from_torch`'s)."""
    out: Dict[str, torch.Tensor] = {}
    _bn(out, "bn0", sd, "bn0.bn")
    for d in range(num_downs):
        prefix = "unet_block." + "mid_forward." * d
        out[prefix + ("down_forward.0.weight" if d == 0
                      else "down_forward.1.weight")] = sd[
                          f"down{d}.conv.weight"]
        if 0 < d < num_downs - 1:
            _bn(out, prefix + "down_forward.2", sd, f"down_bn{d}.bn")
        out[prefix + "up_forward.2.weight"] = sd[f"up{d}.conv.weight"]
        if f"up{d}.conv.bias" in sd:
            out[prefix + "up_forward.2.bias"] = sd[f"up{d}.conv.bias"]
        if d > 0:
            _bn(out, prefix + "up_forward.3", sd, f"up_bn{d}.bn")
    return out


# the reference wrapper's nn.Sequential index of each trunk module (the
# inverse of torch_import._RESNET_SEQ)
_RESNET_IDX = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
               "layer3": "6", "layer4": "7"}


def resnet_to_torch(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A ``FrameEncoder`` ``state_dict`` -> the reference's ``ResnetFC`` /
    ``ResnetDilated`` keys (``features.N...`` and ``fc.*``,
    vision_net.py:26-30, :88-92)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if not k.startswith("features."):
            out[k] = v
            continue
        module, rest = k[len("features."):].split(".", 1)
        layer, _, block = module.partition("_")
        if block:                       # layer{li}_{bi}: a BasicBlock
            rest = (rest.replace("downsample_conv.", "downsample.0.")
                    .replace("downsample_bn.", "downsample.1."))
            out[f"features.{_RESNET_IDX[layer]}.{block}.{rest}"] = v
        else:
            out[f"features.{_RESNET_IDX[module]}.{rest}"] = v
    return out


def synthesizer_to_torch(sd: Mapping) -> Dict[str, torch.Tensor]:
    """An ``InnerProd`` / ``Bias`` ``state_dict`` -> the reference's
    (synthesizer_net.py:6-70): the same names."""
    return dict(sd)


def save_torch_checkpoint(sd: Mapping, path: str) -> None:
    """Write a ``state_dict`` as a ``.pth`` of contiguous CPU tensors."""
    torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()},
               path)
