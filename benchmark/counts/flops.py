"""FLOPs of the published nets, counted from a configuration's shapes.

The count is of what the algorithm needs and not of how the program
computes it: every convolution (2 x multiply-adds) and the synthesizer's
inner products.  The STFT, the log-frequency warp, the fusion's attention
and all elementwise work are left out, so a change to how those are
implemented (an FFT or a matrix DFT, a gather or a matrix warp) leaves the
yardstick where it was; they are under 1 % of a step.

A training step counts each convolution's forward, its weight gradient,
and its input gradient where the input needs one (not for the first
convolution of a net whose input is data); a forward without a gradient
counts once.  The counts equal ``torch.utils.flop_counter`` on the plain
reference (``benchmark/tests/test_benchmark_counts.py``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# one convolution: (flops of its forward, whether its input takes a grad)
Conv = Tuple[int, bool]


def conv_flops(b: int, cin: int, cout: int, k: int, hout: int,
               wout: int) -> int:
    return 2 * b * cin * cout * k * k * hout * wout


def conv3d_flops(b: int, cin: int, cout: int, kt: int, kh: int, kw: int,
                 tout: int, hout: int, wout: int) -> int:
    return 2 * b * cin * cout * kt * kh * kw * tout * hout * wout


def _out(size: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def unet(b: int, h: int, w: int, fc_dim: int, num_downs: int,
         ngf: int = 64, extra: int = 0) -> List[Conv]:
    """The U-Net's convolutions on ``[b, 1, h, w]``: 4x4 stride-2 downs,
    3x3 ups after a 2x upsample, the skip doubling the up inputs; with
    ``extra`` the innermost down emits that many more channels, split off
    before the decoder (the SoP++ basis U-Net).  Every input takes a
    gradient: the first conv's comes from the learned ``bn0``."""
    feats = [ngf, ngf * 2, ngf * 4, ngf * 8] + [ngf * 8] * (num_downs - 4)
    feats = feats[:num_downs]
    out: List[Conv] = []
    for d in range(num_downs):
        cin = 1 if d == 0 else feats[d - 1]
        cout = feats[d] + (extra if d == num_downs - 1 else 0)
        out.append((conv_flops(b, cin, cout, 4, h >> (d + 1), w >> (d + 1)),
                    True))
    for d in range(num_downs - 1, -1, -1):
        cin = feats[d] if (extra and d == num_downs - 1) else 2 * feats[d]
        cout = fc_dim if d == 0 else feats[d - 1]
        out.append((conv_flops(b, cin, cout, 3, h >> d, w >> d), True))
    return out


def resnet18_dilated(b: int, h: int, w: int, fc_dim: int) -> List[Conv]:
    """ResNet18 with layer4's stride turned into dilation 2, then the 3x3
    ``fc`` to ``fc_dim``, on ``[b, 3, h, w]`` frames (data: the first
    convolution takes no input gradient)."""
    out: List[Conv] = []
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    out.append((conv_flops(b, 3, 64, 7, h, w), False))
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)            # max-pool
    cin = 64
    for cout, stride in ((64, 1), (128, 2), (256, 2), (512, 1)):
        for block in range(2):
            s = stride if block == 0 else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            out.append((conv_flops(b, cin, cout, 3, ho, wo), True))
            out.append((conv_flops(b, cout, cout, 3, ho, wo), True))
            if block == 0 and (s != 1 or cin != cout):
                out.append((conv_flops(b, cin, cout, 1, ho, wo), True))
            h, w, cin = ho, wo, cout
    out.append((conv_flops(b, 512, fc_dim, 3, h, w), True))
    return out


def resnet3d_fast(b: int, t: int, h: int, w: int,
                  base: int = 8, blocks=(3, 4, 6, 3)) -> List[Conv]:
    """The SlowFast fast pathway (ResNet3d-50 at ``base`` channels) on
    ``[b, 3, t, h, w]`` clips (data: the stem takes no input gradient):
    the 5x7x7 stem at stride (1, 2, 2), a (1, 3, 3) max-pool at stride
    (1, 2, 2), then bottlenecks of a 3x1x1 conv1, a 1x3x3 conv2 carrying
    the stage's spatial stride, a 1x1x1 conv3 to 4 x planes, and a 1x1x1
    strided downsample where the shape changes.  Time keeps its length."""
    out: List[Conv] = []
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    out.append((conv3d_flops(b, 3, base, 5, 7, 7, t, h, w), False))
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)            # max-pool
    cin = base
    for stage, n in enumerate(blocks):
        planes = base * 2 ** stage
        for block in range(n):
            s = 2 if stage > 0 and block == 0 else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            out.append((conv3d_flops(b, cin, planes, 3, 1, 1, t, h, w), True))
            out.append((conv3d_flops(b, planes, planes, 1, 3, 3, t, ho, wo),
                        True))
            out.append((conv3d_flops(b, planes, 4 * planes, 1, 1, 1, t, ho,
                                     wo), True))
            if s != 1 or cin != 4 * planes:
                out.append((conv3d_flops(b, cin, 4 * planes, 1, 1, 1, t, ho,
                                         wo), True))
            h, w, cin = ho, wo, 4 * planes
    return out


def forward(convs: List[Conv]) -> int:
    return sum(f for f, _ in convs)


def trained(convs: List[Conv]) -> int:
    """Forward, weight gradient, and input gradient where one is taken."""
    return sum(f * (3 if grad_in else 2) for f, grad_in in convs)


def _shapes(cfg: Dict) -> Tuple[int, int, int]:
    """``(warped bins, STFT frames, U-Net levels)`` of a configuration."""
    frames = 1 + cfg["audLen"] // cfg["stft_hop"]
    bins = 256 if cfg["log_freq"] else cfg["stft_frame"] // 2 + 1
    return bins, frames, int(cfg["arch_sound"][-1])


def train_step(cfg: Dict, b: int, use_vis: bool, model: str) -> int:
    """FLOPs of one training step of ``b`` rows: ``model`` ``avsep`` (the
    joint AV double pass over each source's frame net, or under
    ``fusion_type CoLoc_ClipAtt`` its motion net over ``clip_len`` frames,
    and no frame net; or the AO pass) or ``sop`` (stage 3, or AO)."""
    bins, frames, nd = _shapes(cfg)
    n, img = cfg["num_mix"], cfg["imgSize"]
    if model == "avsep":
        net = unet(b, bins, frames, cfg["num_channels"], nd)
        if not use_vis:
            return trained(net)
        if cfg["fusion_type"] == "CoLoc_ClipAtt":      # the motion net
            vis = resnet3d_fast(b, cfg["clip_len"], img, img)
        else:
            vis = resnet18_dilated(b, img, img, cfg["vis_channels"])
        return 2 * trained(net) + n * trained(vis)
    c = cfg["num_channels"]
    net = unet(b, bins, frames, c, nd, extra=c * n)
    synth = n * 2 * b * bins * frames * c   # <ctx * scale, basis> per source
    flops = trained(net) + 3 * synth
    if use_vis:
        flops += n * forward(resnet18_dilated(b, img, img,
                                              cfg["vis_channels"]))
        flops += trained(resnet18_dilated(b, img, n * img,
                                          cfg["vis_channels"]))
    return flops


def separate(cfg: Dict, b: int, use_vis: bool) -> int:
    """FLOPs of separating ``b`` mixtures (the flagship's nets, no grad)."""
    bins, frames, nd = _shapes(cfg)
    flops = forward(unet(b, bins, frames, cfg["num_channels"], nd))
    if use_vis:
        flops += cfg["num_mix"] * forward(resnet18_dilated(
            b, cfg["imgSize"], cfg["imgSize"], cfg["vis_channels"]))
    return flops


def per_kind(cfg: Dict, b: int, model: str) -> Dict[bool, int]:
    """``{use_vis: FLOPs}`` of a training step of ``b`` rows."""
    return {v: train_step(cfg, b, v, model) for v in (True, False)}
