"""The plain reference: the published model's layers in plain PyTorch.

Written from the model's description (the audio-visual separation
codebase's ``models/audio_net.py``, ``vision_net.py``, ``fusion_net.py``,
``criterion.py``, ``synthesizer_net.py``, SoP++'s ``attention_net.py``,
``main.py``, and for the motion net the SlowFast paper's fast pathway as
mmaction2 builds it), functionally: every layer takes its weights from
one dict keyed by the published module names (``sound.down3.conv.weight``,
``motion.layer2_0.downsample_conv.weight``), the dict the benchmark made
from the seed.  It imports nothing of the program and of the JAX package,
and takes nothing the program made.

Precision (:class:`Precision`): ``float32`` runs every layer in float32;
``bfloat16`` casts each convolution's input, weight and bias to bfloat16
and returns BatchNorm's float32 normalization in bfloat16, as the
configuration's mixed precision states (parameters, statistics, fusion,
STFT and losses stay float32).  ``fp8`` additionally rounds each
convolution's input and weight to float8 e4m3 with a per-tensor scale
(amax / 448): the control, one precision below bfloat16.  TF32 is set by
the caller around a run (:func:`tf32`).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

W = Dict[str, torch.Tensor]
E4M3_MAX = 448.0


@dataclass(frozen=True)
class Precision:
    compute: str = "float32"     # float32 | bfloat16 | fp8

    @property
    def dtype(self) -> torch.dtype:
        return torch.float32 if self.compute == "float32" else torch.bfloat16


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for cuDNN convolutions and cuBLAS products on or off inside."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(x.dtype)


# ------------------------------------------------------------------ layers


def conv(x, w: W, name: str, P: Precision, stride=1, padding=0,
         dilation=1) -> torch.Tensor:
    """A 2-D convolution, or a 3-D one where the weight is 5-D."""
    weight, bias = w[name + ".weight"], w.get(name + ".bias")
    op = F.conv3d if weight.dim() == 5 else F.conv2d
    if P.compute == "float32":
        return op(x, weight, bias, stride, padding, dilation)
    d = P.dtype
    x, weight = x.to(d), weight.to(d)
    if P.compute == "fp8":
        x, weight = _fp8(x), _fp8(weight)
    y = op(x, weight, None, stride, padding, dilation)
    return y if bias is None else \
        y + bias.to(d).view([-1] + [1] * (weight.dim() - 2))


def batch_norm(x, w: W, name: str, P: Precision, train: bool,
               eps: float = 1e-5, momentum: float = 0.9) -> torch.Tensor:
    """Over the channels of dim 1, in float32, out in the compute dtype.
    Train mode normalizes with the batch's mean and biased variance and
    moves the running statistics (``ra = m ra + (1 - m) batch``, the
    biased variance) in place in ``w``."""
    shape = [1, -1] + [1] * (x.dim() - 2)
    dims = [0] + list(range(2, x.dim()))
    xf = x.float()
    rm, rv = w[name + ".running_mean"], w[name + ".running_var"]
    if train:
        mean = xf.mean(dims)
        var = ((xf - mean.view(shape)) ** 2).mean(dims)
        with torch.no_grad():
            rm.mul_(momentum).add_(mean.detach(), alpha=1 - momentum)
            rv.mul_(momentum).add_(var.detach(), alpha=1 - momentum)
    else:
        mean, var = rm, rv
    y = (xf - mean.view(shape)) / torch.sqrt(var.view(shape) + eps) \
        * w[name + ".weight"].view(shape) + w[name + ".bias"].view(shape)
    return y.to(P.dtype)


def leaky_relu(x):
    return torch.where(x >= 0, x, 0.2 * x)


def cosine(a, b, dim: int, eps: float = 1e-8):
    na = torch.clamp(torch.linalg.vector_norm(a, dim=dim), min=eps)
    nb = torch.clamp(torch.linalg.vector_norm(b, dim=dim), min=eps)
    return torch.sum(a * b, dim=dim) / (na * nb)


# --------------------------------------------------------------- the U-Net


def unet(x, w: W, P: Precision, train: bool, num_downs: int, fuse,
         extra: int = 0, pre: str = "sound."):
    """``x [B, 1, H, W]`` log magnitude -> NCHW output of the outer conv.
    The encoder: a learned BatchNorm on the input, 4x4 stride-2 convs, a
    LeakyReLU(0.2) before every conv after the first, BatchNorm after every
    conv but the first and the innermost.  ``fuse(h) -> h'`` runs at the
    bottleneck (NCHW in, NCHW out); with ``extra`` the innermost conv's
    first ``extra`` channels are split off instead and returned.  The
    decoder: ReLU, bilinear 2x upsample (align corners), 3x3 conv,
    BatchNorm, then the skip concatenated in front."""
    h = batch_norm(x, w, pre + "bn0.bn", P, train)
    skips = []
    for d in range(num_downs):
        if d > 0:
            h = leaky_relu(h)
        h = conv(h, w, f"{pre}down{d}.conv", P, stride=2, padding=1)
        if 0 < d < num_downs - 1:
            h = batch_norm(h, w, f"{pre}down_bn{d}.bn", P, train)
        skips.append(h)
    side = None
    if extra:
        side, h = h[:, :extra], h[:, extra:]
    else:
        h = fuse(h)
    for d in range(num_downs - 1, -1, -1):
        h = torch.relu(h)
        h = F.interpolate(h, scale_factor=2, mode="bilinear",
                          align_corners=True)
        h = conv(h, w, f"{pre}up{d}.conv", P, padding=1)
        if d > 0:
            h = batch_norm(h, w, f"{pre}up_bn{d}.bn", P, train)
            h = torch.cat([skips[d - 1], h], dim=1)
    return h, side


# ---------------------------------------------------------- the frame net

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_frames(frames: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (channels last) -> ImageNet-normalized float32; float
    frames in [0, 1] are normalized without the 1/255."""
    x = frames.float()
    if frames.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def _block(h, w: W, name: str, P, train, stride, dil_first, dil):
    y = conv(h, w, name + ".conv1", P, stride=stride, padding=dil_first,
             dilation=dil_first)
    y = torch.relu(batch_norm(y, w, name + ".bn1", P, train))
    y = conv(y, w, name + ".conv2", P, padding=dil, dilation=dil)
    y = batch_norm(y, w, name + ".bn2", P, train)
    if name + ".downsample_conv.weight" in w:
        h = batch_norm(conv(h, w, name + ".downsample_conv", P,
                            stride=stride), w, name + ".downsample_bn", P,
                       train)
    return torch.relu(y + h)


def resnet18_dilated(x, w: W, P: Precision, train: bool,
                     pre: str = "frame.") -> torch.Tensor:
    """Normalized frames NHWC -> the spatial map NHWC: ResNet18 with
    layer4's stride replaced by dilation (its first 3x3 conv keeps
    dilation 1, the later ones dilation 2), then the 3x3 ``fc`` conv."""
    f = pre + "features."
    h = conv(x.permute(0, 3, 1, 2), w, f + "conv1", P, stride=2, padding=3)
    h = torch.relu(batch_norm(h, w, f + "bn1", P, train))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    for layer, stride, dil in ((1, 1, 0), (2, 2, 0), (3, 2, 0), (4, 2, 2)):
        for b in (0, 1):
            s = 1 if (b or dil) else stride
            first = (dil // 2 or 1) if b == 0 else (dil or 1)
            h = _block(h, w, f"{f}layer{layer}_{b}", P, train, s, first,
                       dil or 1)
    h = conv(h, w, pre + "fc", P, padding=1)
    return h.permute(0, 2, 3, 1)


def frame_map(frames, w: W, P: Precision, train: bool,
              pre: str = "frame.") -> torch.Tensor:
    """One stream's frames ``[B, T, H, W, 3]`` -> ReLU of the temporal mean
    of the frame maps ``[B, h, w, D]``."""
    B, T = frames.shape[:2]
    x = normalize_frames(frames.reshape((B * T,) + frames.shape[2:]))
    y = resnet18_dilated(x, w, P, train, pre)
    y = y.reshape((B, T) + y.shape[1:]).mean(dim=1)
    return torch.relu(y)


# -------------------------------------------------------- the motion net


def _bottleneck3d(h, w: W, name: str, P, train, stride):
    y = conv(h, w, name + ".conv1", P, padding=(1, 0, 0))
    y = torch.relu(batch_norm(y, w, name + ".bn1", P, train))
    y = conv(y, w, name + ".conv2", P, stride=(1, stride, stride),
             padding=(0, 1, 1))
    y = torch.relu(batch_norm(y, w, name + ".bn2", P, train))
    y = batch_norm(conv(y, w, name + ".conv3", P), w, name + ".bn3", P,
                   train)
    if name + ".downsample_conv.weight" in w:
        h = batch_norm(conv(h, w, name + ".downsample_conv", P,
                            stride=(1, stride, stride)), w,
                       name + ".downsample_bn", P, train)
    return torch.relu(y + h)


def resnet3d_fast(x, w: W, P: Precision, train: bool,
                  blocks=(3, 4, 6, 3), pre: str = "motion.") -> torch.Tensor:
    """The SlowFast fast pathway (Feichtenhofer et al., ICCV 2019; mmaction2's
    ``ResNet3dSlowFast`` ``fast_pathway``: depth 50, ``base_channels`` 8,
    ``conv1_kernel`` (5, 7, 7), ``conv1_stride_t`` 1, ``pool1_stride_t``
    1, ``inflate_style`` '3x1x1', no lateral connections): normalized
    clips ``[B, T, H, W, 3]`` -> the map ``[B, T, H/32, W/32, 256]``.

    The stem: a 5x7x7 convolution at stride (1, 2, 2), BatchNorm, ReLU, a
    (1, 3, 3) max-pool at stride (1, 2, 2) padded with -inf.  Each
    bottleneck: a 3x1x1 ``conv1`` (every block inflated), a 1x3x3
    ``conv2`` carrying the stage's spatial stride (2 in the first block
    of stages 2 to 4), a 1x1x1 ``conv3`` to 4 x planes, a BatchNorm after
    each and ReLU after the first two, the shortcut a strided 1x1x1
    ``downsample_conv`` with its BatchNorm where the shape changes, ReLU
    after the sum.  Departures from mmaction2's layer: no ``pool2`` (the
    SlowFast forward runs the stages without it, as here); the map comes
    back channels last, as the fusion reads it; weights are what the
    caller hands in (mmaction2 zero-initializes each ``bn3`` scale, the
    benchmark draws every weight from its seed); the running variance
    moves by the biased batch variance, as for every net here (PyTorch's
    BatchNorm uses the unbiased one; a training step does not read it).
    Keys name the blocks ``layer2_0`` where mmaction2 writes
    ``layer2.0``."""
    h = conv(x.permute(0, 4, 1, 2, 3), w, pre + "conv1", P,
             stride=(1, 2, 2), padding=(2, 3, 3))
    h = torch.relu(batch_norm(h, w, pre + "bn1", P, train))
    h = F.max_pool3d(F.pad(h, (1, 1, 1, 1), value=-math.inf), (1, 3, 3),
                     stride=(1, 2, 2))
    for stage, n in enumerate(blocks):
        for b in range(n):
            h = _bottleneck3d(h, w, f"{pre}layer{stage + 1}_{b}", P, train,
                              2 if stage > 0 and b == 0 else 1)
    return h.permute(0, 2, 3, 4, 1)


def motion_map(clips, w: W, P: Precision, train: bool,
               pre: str = "motion.") -> torch.Tensor:
    """One stream's clips ``[B, T, H, W, 3]`` -> ReLU of the temporal mean
    of the fast pathway's map ``[B, h, w, 256]``."""
    y = resnet3d_fast(normalize_frames(clips), w, P, train, pre=pre)
    return torch.relu(y.mean(dim=1))


# ------------------------------------------------- the STFT and the warp


def hann(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * k / n)).float()


def stft(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """librosa's STFT (centered, reflect padding, periodic Hann):
    ``[..., L]`` -> complex ``[..., F, 1 + L // hop]``."""
    lead = audio.shape[:-1]
    x = F.pad(audio.reshape(-1, 1, audio.shape[-1]).float(),
              (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop) * hann(n_fft, x.device)
    spec = torch.fft.rfft(frames, dim=-1).transpose(-1, -2)
    return spec.reshape(lead + spec.shape[-2:])


def istft(spec: torch.Tensor, hop: int) -> torch.Tensor:
    """librosa's inverse: windowed overlap-add over the summed squared
    window (sums under float32's tiny left alone), trimmed by n_fft / 2."""
    lead, (Fb, T) = spec.shape[:-2], spec.shape[-2:]
    n_fft = 2 * (Fb - 1)
    win = hann(n_fft, spec.device)
    frames = torch.fft.irfft(spec.reshape(-1, Fb, T).transpose(-1, -2),
                             n=n_fft, dim=-1) * win          # [R, T, n_fft]
    full = n_fft + hop * (T - 1)
    out = F.fold(frames.transpose(1, 2), (1, full), (1, n_fft),
                 stride=(1, hop))[:, 0, 0]
    wss = F.fold((win * win).expand(1, T, n_fft).transpose(1, 2),
                 (1, full), (1, n_fft), stride=(1, hop))[0, 0, 0]
    wss = torch.where(wss > torch.finfo(torch.float32).tiny, wss,
                      torch.ones_like(wss))
    out = (out / wss)[:, n_fft // 2: full - n_fft // 2]
    return out.reshape(lead + out.shape[-1:])


def warp_grid(bins_out: int, width: int, warp: bool, device):
    """The reference's ``warpgrid``: the output's frequency rows at
    ``(21 ** ((y + 1) / 2) - 11) / 10`` (log-frequency) or its inverse,
    the time axis on ``linspace(-1, 1)``."""
    x = torch.linspace(-1, 1, width, dtype=torch.float64, device=device)
    y = torch.linspace(-1, 1, bins_out, dtype=torch.float64, device=device)
    gy = (torch.pow(21.0, (y + 1) / 2) - 11) / 10 if warp else \
        torch.log(y * 10 + 11) / math.log(21) * 2 - 1
    grid = torch.stack(torch.broadcast_tensors(x[None, :], gy[:, None]),
                       dim=-1)
    return grid.float()


def warp(x: torch.Tensor, bins_out: int, warp_on: bool) -> torch.Tensor:
    """``F.grid_sample`` of ``x [..., F, T]`` on the warp grid (bilinear,
    zeros outside, align_corners False), as the reference warps."""
    lead, (Fb, T) = x.shape[:-2], x.shape[-2:]
    grid = warp_grid(bins_out, T, warp_on, x.device)
    flat = x.reshape(-1, 1, Fb, T).float()
    out = F.grid_sample(flat, grid.expand(flat.shape[0], -1, -1, -1),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.reshape(lead + out.shape[-2:])


# ----------------------------------------------------------------- losses


def bce(pred, target):
    """Binary cross entropy with the input clipped to [1e-7, 1 - 1e-7] and
    each log clamped at -100."""
    p = torch.clamp(pred, 1e-7, 1 - 1e-7)
    return -(target * torch.clamp(torch.log(p), min=-100.0)
             + (1 - target) * torch.clamp(torch.log(1 - p), min=-100.0))


def prepare(mag_mix, mags, log_freq: bool, weighted: bool):
    """mixture + 1e-10, the log-frequency warp of it and of the sources,
    weights ``clamp(log1p(mix), 1e-3, 10)``, binary masks ``mags > mix/2``,
    and the detached log mixture."""
    mag_mix = mag_mix + 1e-10
    if log_freq:
        mag_mix, mags = warp(mag_mix, 256, True), warp(mags, 256, True)
    weights = torch.clamp(torch.log1p(mag_mix), 1e-3, 10.0) if weighted \
        else torch.ones_like(mag_mix)
    gt = (mags > 0.5 * mag_mix[:, None]).float()
    return mag_mix, gt, weights, torch.log(mag_mix).detach()


def pit(preds, gts, weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-source permutation-invariant BCE: ``preds, gts [B, N, H, W]``;
    per row the smaller of the identity's and the swap's mean loss (ties
    to the identity).  Returns ``(loss [B], swapped [B])``."""
    def mean_loss(p):
        return (bce(p, gts) * weights[:, None]).mean(dim=(1, 2, 3))
    ident, swap = mean_loss(preds), mean_loss(preds.flip(1))
    swapped = swap < ident
    return torch.where(swapped, swap, ident), swapped
