"""Seeded weights, made on the device in a few large draws.

The benchmark makes the weights itself and hands the same tensors to the
program (``load_state_dict``) and to the plain reference, so neither side
takes anything the other made.  The names and shapes are the program's
``state_dict`` keys, which are the published model's module names
(``sound.down3.conv.weight``, ``frame.features.layer4_0.conv1.weight``).

The initializers are the reference code's (``models/__init__.py``): the
U-Nets' convolutions N(0, 0.001), their BatchNorm scales N(1, 0.02), the
outer convolution's bias U(+-1/sqrt(fan_in)); the ResNet's convolutions
He-normal on fan-out with unit BatchNorm; the synthesizer's scale ones.
Running statistics start at mean 0 and variance 1.  Every normal draw of a
run is one ``torch.randn`` and every uniform draw one ``torch.rand``, from
one device generator seeded from the run's seed.

A served model has trained weights, and the repository holds none.  Under
the reference's initializers the U-Net's N(0, 0.001) convolutions shrink
its activations to nothing in eval mode, so every mask is its outer bias
and no input moves an answer.  The ``served`` scheme stands in for trained
weights instead: every convolution He-normal on fan-in (variance kept
through each layer), BatchNorm at unit scale, biases zero, so the masks
depend on the mixture and the frames as a trained model's do.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# rule: ("normal", mean, std) | ("uniform", lo, hi) | ("const", value)
Rule = Tuple


def _rule(net: str, key: str, shape: torch.Size, sd,
          scheme: str = "reference") -> Rule:
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked" or leaf == "running_mean":
        return ("const", 0.0)
    if leaf == "running_var":
        return ("const", 1.0)
    if scheme == "served":
        if len(shape) >= 4:
            fan_in = math.prod(shape[1:])
            return ("normal", 0.0, math.sqrt(2.0 / fan_in))
        return ("const", 1.0 if leaf in ("weight", "scale") else 0.0)
    if net == "synthesizer":
        return ("const", 1.0 if leaf == "scale" else 0.0)
    if len(shape) >= 4:                                   # a conv weight
        if net == "sound":
            return ("normal", 0.0, 0.001)
        fan_out = shape[0] * math.prod(shape[2:])
        return ("normal", 0.0, math.sqrt(2.0 / fan_out))
    if leaf == "bias":
        w = sd.get(key[:-len("bias")] + "weight")
        if net == "sound" and w is not None and w.dim() >= 4:
            bound = 1.0 / math.sqrt(w[0].numel())
            return ("uniform", -bound, bound)
        return ("const", 0.0)
    # a BatchNorm scale
    return ("normal", 1.0, 0.02) if net == "sound" else ("const", 1.0)


def make(nets: Dict[str, torch.nn.Module], generator: torch.Generator,
         device, scheme: str = "reference") -> Dict[str, torch.Tensor]:
    """Every ``state_dict`` entry of ``nets`` (name -> module), keyed
    ``<net>.<key>``, drawn on ``device`` from ``generator`` under
    ``scheme`` (``reference`` or ``served``)."""
    entries = []
    for net, module in nets.items():
        sd = module.state_dict()
        for key, t in sd.items():
            entries.append((f"{net}.{key}", t.shape, t.dtype,
                            _rule(net, key, t.shape, sd, scheme)))
    sizes = {kind: sum(math.prod(s) for _, s, _, r in entries
                       if r[0] == kind) for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=generator,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=generator,
                                   device=device)}
    offset = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, dtype, rule in entries:
        n = math.prod(shape)
        if rule[0] == "const":
            out[name] = torch.full(shape, rule[1], dtype=dtype, device=device)
            continue
        kind = rule[0]
        piece = pools[kind][offset[kind]:offset[kind] + n].view(shape)
        offset[kind] += n
        if kind == "normal":
            piece = rule[1] + rule[2] * piece
        else:
            piece = rule[1] + (rule[2] - rule[1]) * piece
        out[name] = piece.to(dtype).clone()
    return out


def load(nets: Dict[str, torch.nn.Module],
         weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``nets``, strictly; the harness keeps its own
    tensors."""
    for net, module in nets.items():
        pre = net + "."
        module.load_state_dict({k[len(pre):]: v for k, v in weights.items()
                                if k.startswith(pre)}, strict=True)
