"""Log-frequency warp of spectrograms as two small GEMMs.

Port of ``avsep_tpu/ops/warp.py``.  The reference warps 512-bin
linear-frequency spectrograms onto a 256-bin log-frequency axis with
``F.grid_sample(mag, warpgrid(...), align_corners=False)`` (reference
``utils.py:12-26``, ``main.py:61-66``) and un-warps predicted masks the same
way (reference ``main.py:217-220``).  The warp grid is separable, so the
bilinear sampling factorises into ``out = Wy @ img @ Wx.T`` with dense
interpolation matrices that bake in ``align_corners=False`` and zero
padding.  :func:`grid_sample` is the general, non-separable sampler.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def warpgrid_coords(HO: int, WO: int, warp: bool = True):
    """The 1-D normalized grid coordinates of reference ``utils.py:12-26``.

    Returns (grid_x [WO], grid_y [HO]) in [-1, 1] normalized space.
    """
    x = np.linspace(-1, 1, WO)
    y = np.linspace(-1, 1, HO)
    if warp:
        gy = (np.power(21, (y + 1) / 2) - 11) / 10
    else:
        gy = np.log(y * 10 + 11) / np.log(21) * 2 - 1
    return x.astype(np.float32), gy.astype(np.float32)


def warpgrid(bs: int, HO: int, WO: int, warp: bool = True) -> np.ndarray:
    """Full [bs, HO, WO, 2] grid, as reference ``utils.warpgrid``."""
    gx, gy = warpgrid_coords(HO, WO, warp)
    grid = np.zeros((bs, HO, WO, 2), np.float32)
    grid[..., 0] = gx[None, None, :]
    grid[..., 1] = gy[None, :, None]
    return grid


def _interp_matrix(coords: np.ndarray, in_size: int) -> np.ndarray:
    """Dense [out, in] bilinear interpolation matrix for normalized coords,
    with ``grid_sample(align_corners=False, padding_mode='zeros')`` 1-D
    semantics: pixel position ``p = ((c + 1) * S - 1) / 2``; taps outside
    the input contribute zero."""
    out = np.zeros((len(coords), in_size), np.float64)
    p = ((coords.astype(np.float64) + 1.0) * in_size - 1.0) / 2.0
    lo = np.floor(p).astype(np.int64)
    w_hi = p - lo
    for i, (l, w) in enumerate(zip(lo, w_hi)):
        if 0 <= l < in_size:
            out[i, l] += 1.0 - w
        if 0 <= l + 1 < in_size:
            out[i, l + 1] += w
    return out.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _warp_matrices(H_in: int, W_in: int, HO: int, WO: int, warp: bool,
                   device: torch.device):
    """(Wy [HO, H_in], Wx^T [W_in, WO]) on ``device``, cached for the life
    of the process."""
    gx, gy = warpgrid_coords(HO, WO, warp)
    Wy = torch.from_numpy(_interp_matrix(gy, H_in)).to(device)
    WxT = torch.from_numpy(
        np.ascontiguousarray(_interp_matrix(gx, W_in).T)).to(device)
    return Wy, WxT


def warp_spectrogram(x: torch.Tensor, HO: int = 256, WO: Optional[int] = None,
                     warp: bool = True) -> torch.Tensor:
    """Warp ``x [..., H, W]`` to ``[..., HO, WO]`` on the log-frequency grid.

    Equals ``F.grid_sample(x, warpgrid(B, HO, WO, warp), align_corners=
    False)`` (reference ``main.py:61-66``), as two float32 GEMMs (full f32
    while ``torch.backends.cuda.matmul.allow_tf32`` keeps its default,
    False).
    """
    H_in, W_in = x.shape[-2], x.shape[-1]
    if WO is None:
        WO = W_in
    Wy, WxT = _warp_matrices(H_in, W_in, HO, WO, warp, x.device)
    y = torch.matmul(Wy, x.float())      # [..., HO, W_in]
    return torch.matmul(y, WxT)          # [..., HO, WO]


def unwarp_mask(mask: torch.Tensor, HO: int = 512) -> torch.Tensor:
    """Un-warp a log-frequency mask back to ``HO`` linear-frequency bins
    (reference ``main.py:217-220``); the time width is kept."""
    return warp_spectrogram(mask, HO=HO, WO=mask.shape[-1], warp=False)


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """General bilinear ``F.grid_sample(x, grid, align_corners=False,
    padding_mode='zeros')`` for NCHW ``x [B, C, H, W]`` and ``grid [B, HO,
    WO, 2]`` holding normalized (x, y) coordinates; a sample point outside
    ``[-1, 1]`` takes zeros for its taps that fall off the image (port of
    ``avsep_tpu/ops/warp.py:111-142``, which gathers the four taps
    itself).  Use :func:`warp_spectrogram` for the separable warp grids."""
    return torch.nn.functional.grid_sample(
        x, grid.to(x.dtype), mode="bilinear", padding_mode="zeros",
        align_corners=False)
