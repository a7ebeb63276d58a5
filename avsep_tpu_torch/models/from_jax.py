"""JAX ``(params, batch_stats)`` trees -> the port's ``state_dict``s.

The port's modules carry the JAX package's module names, so a parameter
path maps one to one onto a ``state_dict`` key and the conversion only
renames leaves and transposes kernels (the layouts of
``avsep_tpu/models/torch_export.py``):

* conv ``kernel [kh, kw, in, out]`` -> ``weight [out, in, kh, kw]``, and
  the motion net's ``[kd, kh, kw, in, out]`` -> ``[out, in, kd, kh, kw]``;
* conv ``bias`` -> ``bias``;
* BatchNorm ``scale`` / ``bias`` (params) and ``mean`` / ``var``
  (batch_stats) -> ``weight`` / ``bias`` / ``running_mean`` /
  ``running_var``, plus the ``num_batches_tracked`` buffer (0) that a
  strict ``load_state_dict`` asks for.

The SoP++ synthesizer's parameters (``InnerProd``: ``scale``, ``bias``;
``Bias``: ``bias``) keep their names: its ``state_dict`` is the JAX tree.

The trees are nested mappings of array-likes (numpy arrays, or anything
``np.asarray`` takes); the module reads them with numpy alone.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def state_dict_from_jax(params: Mapping, batch_stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """One net's JAX ``params`` and ``batch_stats`` -> its ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}

    def put(path, name, value):
        sd[".".join(path + (name,))] = torch.from_numpy(np.array(value))

    for path, leaf in _leaves(params):
        mod, name = path[:-1], path[-1]
        if name == "kernel":
            if leaf.ndim not in (4, 5):
                raise ValueError(f"{'.'.join(path)}: expected a 4-D or 5-D "
                                 f"conv kernel, got shape {leaf.shape}")
            n = leaf.ndim
            put(mod, "weight", leaf.transpose(n - 1, n - 2, *range(n - 2)))
        elif name == "scale":
            put(mod, "weight", leaf)
        elif name == "bias":
            put(mod, "bias", leaf)
        else:
            raise ValueError(f"unknown parameter {'.'.join(path)}")
    for path, leaf in _leaves(batch_stats):
        mod, name = path[:-1], path[-1]
        if name == "mean":
            put(mod, "running_mean", leaf)
            put(mod, "num_batches_tracked", np.asarray(0, np.int64))
        elif name == "var":
            put(mod, "running_var", leaf)
        else:
            raise ValueError(f"unknown batch statistic {'.'.join(path)}")
    return sd


def load_from_jax(nets, params: Mapping, batch_stats: Mapping) -> None:
    """Load the JAX package's ``{"sound": ..., "frame": ...}`` params and
    batch_stats, and ``"motion"`` when ``nets`` has a motion net, into the
    port's ``Nets``, strictly."""
    keys = ("sound", "frame")
    if getattr(nets, "motion", None) is not None:
        keys += ("motion",)
    for key in keys:
        module = getattr(nets, key)
        sd = state_dict_from_jax(params[key], batch_stats[key])
        module.load_state_dict(sd, strict=True)


def synthesizer_state_dict_from_jax(params: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    """The SoP++ synthesizer's JAX ``params`` -> its ``state_dict``."""
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def load_sop_from_jax(nets, params: Mapping, batch_stats: Mapping) -> None:
    """Load the JAX package's SoP++ state (``params`` of ``sound``,
    ``frame`` and ``synthesizer``; ``batch_stats`` of ``sound`` and
    ``frame``) into the port's ``SopNets``, strictly."""
    load_from_jax(nets, params, batch_stats)
    nets.synthesizer.load_state_dict(
        synthesizer_state_dict_from_jax(params["synthesizer"]), strict=True)
