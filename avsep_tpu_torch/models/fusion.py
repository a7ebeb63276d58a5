"""Audio-visual co-localization fusion at the U-Net bottleneck.

Port of ``avsep_tpu/models/fusion.py`` (reference ``models/fusion_net.py``):

* **CoLoc** (``fusion_type='hidsep'``, reference ``fusion_net.py:20-110``):
  split the max-pooled bottleneck vector into C per-source chunks, score all
  C! chunk<->visual-map assignments with cosine or scaled-dot-sigmoid
  attention, pick the best permutation (match loss = -best + sum(rest)),
  attend the visual maps and broadcast per-source guidance vectors back over
  the bottleneck.
* **CoLoc_Sel** (``fusion_net.py:112-226``): the same, with the visual
  feature at the argmax attention pixel as the guidance.
* **MixVis** (``fusion_net.py:229-311``): one mixture visual map; per-chunk
  similarity, argmax-pixel guidance, a match loss with a map-area term and
  a cross-source cosine penalty.

CoLoc's ``option`` ``"duet_h"`` / ``"duet_w"`` (``"duet"`` is ``"duet_h"``)
concatenates the two visual maps along height or width and attends both
chunks over the concatenation (``fusion_net.py:83-90``).

The functions are parameter-free and keep the JAX package's channels-last
layout: bottleneck ``x [B, h, w, D]``, stacked visual maps
``v [C, B, H, W, D/C]``, attention maps ``[B, C, H, W]``.  The audio-only
slot swap takes its uniforms as an input, or draws them from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple, Optional, Tuple

import torch

from avsep_tpu_torch.models.layers import cosine_similarity
from avsep_tpu_torch.parallel.distributed import rank_rand

class FusionOut(NamedTuple):
    features: Optional[torch.Tensor]     # [B, h, w, 2D] fused bottleneck
    match_loss: Optional[torch.Tensor]   # scalar or None (AO path)
    att_maps: Optional[torch.Tensor]     # [B, C, H, W] or None
    match_ps: Optional[torch.Tensor] = None  # per-sample match loss [B]


def _attend(x_pc: torch.Tensor, v: torch.Tensor, att_type: str,
            att_temp: float = 1.0) -> torch.Tensor:
    """Attention scores (reference fusion_net.py:27-33).

    x_pc: [B, ..., Dc] audio chunk vectors; v: [B, ..., H, W, Dc] visual
    maps broadcastable against x_pc's middle dims.  ``att_temp`` divides the
    scores (1.0 is the reference).  Returns per-pixel scores [..., H, W].
    """
    xb = x_pc[..., None, None, :]
    if att_type == "cos":
        sim = cosine_similarity(xb, v, dim=-1)
        return sim if att_temp == 1.0 else sim / att_temp
    if att_type == "sig":
        d = x_pc.shape[-1]
        logits = torch.sum(xb * v / torch.sqrt(
            _scalar(float(d), v.dtype, v.device)), dim=-1)
        if att_temp != 1.0:
            logits = logits / att_temp
        return torch.sigmoid(logits)
    raise ValueError(f"unknown att_type {att_type}")


@functools.lru_cache(maxsize=None)
def _scalar(value: float, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-d tensor of ``value`` on ``device``, made once: a copy from the
    host inside a step would stop a CUDA graph's capture."""
    return torch.tensor(value, dtype=dtype, device=device)


def _pool_chunks(x: torch.Tensor, C: int) -> torch.Tensor:
    """Spatial max-pool of the bottleneck, channels split into C chunks
    (reference fusion_net.py:24,38).  Returns [B, C, D/C]."""
    B, _, _, D = x.shape
    if D % C:
        raise ValueError(
            f"U-Net bottleneck dim {D} must be divisible by num_mix={C} "
            f"for chunked AV fusion (pick ngf so bottleneck % num_mix == 0)")
    g = torch.amax(x, dim=(1, 2))
    return g.reshape(B, C, D // C)


def _broadcast_guidance(feat: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, C, Dc] -> [B, h, w, C*Dc] per-source guidance planes."""
    B, C, Dc = feat.shape
    return feat.reshape(B, 1, 1, C * Dc).expand(B, h, w, C * Dc)


@functools.lru_cache(maxsize=None)
def _perms(C: int, device=None) -> torch.Tensor:
    """All C! orderings as one index table [P, C] in itertools order, the
    identity first (ties in the argmax below go to it); made once per
    device, as :func:`_scalar`."""
    return torch.tensor(list(itertools.permutations(range(C))),
                        dtype=torch.long, device=device)


def _perm_stack(blocks: torch.Tensor) -> torch.Tensor:
    """[B, C, Dc] -> [B, P, C, Dc], every source ordering."""
    return blocks[:, _perms(blocks.shape[1], blocks.device)]


def _score_and_sort(maps: torch.Tensor):
    """maps [B, P, C, H, W] -> (match_loss, match_ps [B], best [B],
    att [B, C, H, W]).

    score(p) = sum_c max_hw maps[p, c]; best = first argmax; match loss =
    mean(-best_score + sum(rest)) (reference fusion_net.py:54-65).
    """
    scores = torch.sum(torch.amax(maps, dim=(3, 4)), dim=2)   # [B, P]
    best = torch.argmax(scores, dim=1)                         # [B]
    best_score = torch.gather(scores, 1, best[:, None])[:, 0]
    rest = torch.sum(scores, dim=1) - best_score
    match_ps = -best_score + rest
    match_loss = torch.mean(match_ps)
    ar = torch.arange(maps.shape[0], device=maps.device)
    att = maps[ar, best]                                       # [B, C, H, W]
    return match_loss, match_ps, best, att


@functools.lru_cache(maxsize=None)
def _pair_orders(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two orderings of a pair, ``[[1, 0]]`` (swapped) and ``[[0, 1]]``
    (kept), on ``device``; made once per device, as :func:`_scalar`."""
    return (torch.tensor([[1, 0]], device=device),
            torch.tensor([[0, 1]], device=device))


def _random_slot_swap(blocks: torch.Tensor, uniforms: torch.Tensor
                      ) -> torch.Tensor:
    """Permute the per-source audio chunks per sample (reference AO_forward,
    fusion_net.py:96-98) from one uniform draw in [0, 1) per sample.

    C = 2 swaps where ``u <= 0.5``, the reference's coin and the JAX
    package's (so the JAX uniforms reproduce its choice exactly).  C > 2
    picks permutation ``floor(u * C!)`` (the JAX package draws an integer
    instead, so only the distribution agrees there).
    """
    B, C, Dc = blocks.shape
    u = uniforms.to(blocks.device).reshape(B)
    if C == 2:
        swap = u <= 0.5
        swapped, kept = _pair_orders(blocks.device)
        perm = torch.where(swap[:, None], swapped, kept)
    else:
        perms = _perms(C, blocks.device)
        pick = torch.clamp((u * perms.shape[0]).long(), max=perms.shape[0] - 1)
        perm = perms[pick]
    return torch.gather(blocks, 1, perm[:, :, None].expand(B, C, Dc))


def swap_uniforms(B: int, uniforms: Optional[torch.Tensor],
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """The audio-only slot swap's ``[B]`` uniforms: ``uniforms`` as given,
    else a draw from ``generator``, made for the global batch and cut to
    this rank's rows under a process group (``distributed.rank_rand``)."""
    if uniforms is not None:
        return torch.as_tensor(uniforms, dtype=torch.float32)
    if generator is None:
        raise ValueError("the audio-only fusion path needs swap uniforms or a "
                         "torch.Generator")
    return rank_rand((B,), generator)


def _ao_forward(x: torch.Tensor, C: int = 2, *,
                uniforms: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> FusionOut:
    """Audio-only path: shuffle the per-source chunks and broadcast them as
    the guidance (reference fusion_net.py:93-104)."""
    B, h, w, D = x.shape
    u = swap_uniforms(B, uniforms, generator)
    blocks = _random_slot_swap(_pool_chunks(x, C), u)
    guidance = _broadcast_guidance(blocks, h, w)
    return FusionOut(torch.cat([guidance, x], dim=-1), None, None)


def _duet_vcat(v: torch.Tensor, axis_h: bool) -> torch.Tensor:
    """Duet option: the two frame maps concatenated along one spatial dim,
    duplicated (reference fusion_net.py:83-90; the reference's host coin
    is the caller's choice of ``axis_h``)."""
    vc = torch.cat([v[0], v[1]], dim=1 if axis_h else 2)
    return torch.stack([vc, vc], dim=0)       # [C=2, B, H', W', Dc]


def coloc(x: torch.Tensor, v: Optional[torch.Tensor], *,
          att_type: str = "cos", option: Optional[str] = None,
          select: bool = False, n_sources: int = 2, att_temp: float = 1.0,
          uniforms: Optional[torch.Tensor] = None,
          generator: Optional[torch.Generator] = None) -> FusionOut:
    """CoLoc / CoLoc_Sel fusion (reference fusion_net.py:20-226).

    Args:
      x: bottleneck audio features [B, h, w, D].
      v: stacked visual maps [C, B, H, W, D/C], or None (audio-only batch).
      option: None | 'duet' (alias 'duet_h') | 'duet_w': concatenate the
        two visual maps along height / width first.
      select: False -> CoLoc (attention-pooled guidance); True -> CoLoc_Sel
        (argmax-pixel guidance, reference fusion_net.py:163-169).
      n_sources: chunk count of the audio-only branch.
      uniforms, generator: the audio-only slot swap's draw (one of them is
        needed when ``v`` is None).
    """
    if v is None:
        return _ao_forward(x, n_sources, uniforms=uniforms,
                           generator=generator)
    if option in ("duet", "duet_h", "duet_w"):
        v = _duet_vcat(v, axis_h=option != "duet_w")

    B, h, w, D = x.shape
    C = v.shape[0]
    blocks = _pool_chunks(x, C)                       # [B, C, Dc]
    x_t = _perm_stack(blocks)                         # [B, P, C, Dc]
    v_cat = v.movedim(0, 1)                           # [B, C, H, W, Dc]
    maps = _attend(x_t, v_cat[:, None], att_type, att_temp)  # [B,P,C,H,W]
    match_loss, match_ps, _, att = _score_and_sort(maps)

    if select:
        _, _, H, W, Dc = v_cat.shape
        max_ind = torch.argmax(att.reshape(B, C, H * W), dim=-1)  # [B, C]
        v_flat = v_cat.reshape(B, C, H * W, Dc)
        feat = torch.gather(
            v_flat, 2, max_ind[:, :, None, None].expand(B, C, 1, Dc))[:, :, 0]
    else:
        feat = torch.amax(v_cat * att[..., None], dim=(2, 3))     # [B, C, Dc]

    guidance = _broadcast_guidance(feat, h, w)
    return FusionOut(torch.cat([guidance, x], dim=-1), match_loss, att,
                     match_ps)


def mixvis(x: torch.Tensor, v: Optional[torch.Tensor], *,
           att_type: str = "cos", option: Optional[str] = None,
           n_sources: int = 2, att_temp: float = 1.0,
           uniforms: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> FusionOut:
    """MixVis fusion against one mixture visual map ``v [1, B, H, W, Dc]``
    (reference fusion_net.py:229-311).  Two sources only; ``option`` and
    ``n_sources`` (beyond the audio-only branch) are accepted for the
    common fusion signature, as in the JAX package."""
    if v is None:
        return _ao_forward(x, n_sources, uniforms=uniforms,
                           generator=generator)
    vm = v[0]                                          # [B, H, W, Dc]
    B, h, w, D = x.shape
    C = 2
    Dc = D // C
    blocks = _pool_chunks(x, C)                        # [B, C, Dc]
    maps = _attend(blocks, vm[:, None], att_type, att_temp)  # [B, C, H, W]

    H, W = vm.shape[1], vm.shape[2]
    flat = maps.reshape(B, C, H * W)
    max_ind = torch.argmax(flat, dim=-1)               # [B, C]
    v_flat = vm.reshape(B, 1, H * W, Dc).expand(B, C, H * W, Dc)
    selected = torch.gather(
        v_flat, 2, max_ind[:, :, None, None].expand(B, C, 1, Dc))[:, :, 0]

    # -sum_c max(map_c) + the map-area term + the cross-source cosine
    # penalty (reference fusion_net.py:258-275; the area is per source)
    match_ps = (torch.sum(-torch.amax(maps, dim=(2, 3)), dim=-1)
                + torch.sum(flat, dim=(1, 2)) / (H * W)
                + cosine_similarity(selected[:, 0], selected[:, 1], dim=1))
    match_loss = torch.mean(match_ps)

    guidance = _broadcast_guidance(selected, h, w)
    return FusionOut(torch.cat([guidance, x], dim=-1), match_loss, maps,
                     match_ps)


def get_fusion(fusion_type: str):
    """Dispatch like reference ``get_fusion_net`` (fusion_net.py:7-18)."""
    if fusion_type in ("hidsep", "con_motion", "share", "CoLoc_ClipAtt"):
        return lambda x, v, **kw: coloc(x, v, select=False, **kw)
    if fusion_type == "CoLoc_Sel":
        return lambda x, v, **kw: coloc(x, v, select=True, **kw)
    if fusion_type == "MixVis":
        return mixvis
    raise ValueError(f"unknown fusion_type {fusion_type}")
