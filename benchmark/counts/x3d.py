"""X3D-M's operations and its channelwise convolutions' bytes, counted from
a configuration's shapes.

:func:`backbone` lists every convolution of the backbone by
``counts/flops.py``'s rules (2 x multiply-adds; a trained convolution
counts its forward, its weight gradient, and its input gradient where the
input takes one: not ``conv1_s``, whose input is data), the gates' 1x1x1
convolutions on one position a clip and the channelwise ones at one input
channel a group included; :func:`fc` is the 3x3 projection of the map's
time mean.  Together they equal ``torch.utils.flop_counter`` on the plain
reference (``benchmark/reference/x3d.py``;
``benchmark/tests/test_benchmark_x3d.py``).

:func:`channelwise` gives the bytes the channelwise convolutions (the
stem's 5x1x1 and each block's 3x3x3) must move in a training step: each
of the three passes (forward: x in, y out; input gradient: dy in, dx out;
weight gradient: x and dy in) reads its two activations once and writes
nothing larger, so a convolution costs three times its input's and its
output's bytes; the weights (27 values a channel) are left out.  At
3.35 TB/s (``counts/bytes.py``) that is the least time any implementation
can take for them.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.counts.flops import Conv, _out, conv3d_flops, conv_flops

BASE = 24
GAMMA_B = 2.25
BLOCKS = (3, 5, 11, 7)
SE_RATIO = 1 / 16
PASSES = 3


def se_width(channels: int, ratio: float = SE_RATIO) -> int:
    """mmaction2's ``_round_width(channels, ratio)``: the nearest multiple
    of 8, at least 8, plus 8 where under 0.9 of the exact value."""
    exact = channels * ratio
    out = max(8, int(exact + 4) // 8 * 8)
    return out + 8 if out < 0.9 * exact else out


def _shapes(t: int, h: int, w: int, base: int, gamma_b: float, blocks):
    """Per block ``(in, inner, out, stride, se, h_in, w_in, h_out,
    w_out)``, after the stem's stride-2 ``conv1_s``."""
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    rows, cin = [], base
    for stage, n in enumerate(blocks):
        out = base * 2 ** stage
        inner = int(out * gamma_b)
        for b in range(n):
            s = 2 if b == 0 else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            rows.append((cin, inner, out, s, b % 2 == 0, h, w, ho, wo))
            h, w, cin = ho, wo, out
    return rows


def backbone(b: int, t: int, h: int, w: int, base: int = BASE,
             gamma_b: float = GAMMA_B, blocks=BLOCKS) -> List[Conv]:
    """X3D's convolutions on ``[b, 3, t, h, w]`` clips, through ``conv5``."""
    h1, w1 = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    out: List[Conv] = [
        (conv3d_flops(b, 3, base, 1, 3, 3, t, h1, w1), False),
        (conv3d_flops(b, 1, base, 5, 1, 1, t, h1, w1), True)]
    rows = _shapes(t, h, w, base, gamma_b, blocks)
    for cin, inner, cout, s, se, hi, wi, ho, wo in rows:
        out.append((conv3d_flops(b, cin, inner, 1, 1, 1, t, hi, wi), True))
        out.append((conv3d_flops(b, 1, inner, 3, 3, 3, t, ho, wo), True))
        if se:
            mid = se_width(inner)
            out.append((conv3d_flops(b, inner, mid, 1, 1, 1, 1, 1, 1), True))
            out.append((conv3d_flops(b, mid, inner, 1, 1, 1, 1, 1, 1), True))
        out.append((conv3d_flops(b, inner, cout, 1, 1, 1, t, ho, wo), True))
        if s != 1 or cin != cout:
            out.append((conv3d_flops(b, cin, cout, 1, 1, 1, t, ho, wo),
                        True))
    c5 = rows[-1][2]
    ho, wo = rows[-1][7], rows[-1][8]
    out.append((conv3d_flops(b, c5, int(c5 * gamma_b), 1, 1, 1, t, ho, wo),
                True))
    return out


def fc(b: int, h: int, w: int, fc_dim: int = 256, base: int = BASE,
       gamma_b: float = GAMMA_B, blocks=BLOCKS) -> List[Conv]:
    """The 3x3 ``fc`` from the map's time mean to ``fc_dim`` channels."""
    ho, wo = h, w
    for _ in range(1 + len(blocks)):
        ho, wo = _out(ho, 3, 2, 1), _out(wo, 3, 2, 1)
    c5 = int(base * 2 ** (len(blocks) - 1) * gamma_b)
    return [(conv_flops(b, c5, fc_dim, 3, ho, wo), True)]


def macs(convs: List[Conv]) -> int:
    """Multiply-adds of the forwards."""
    return sum(f for f, _ in convs) // 2


def channelwise_shapes(t: int, h: int, w: int, base: int = BASE,
                       gamma_b: float = GAMMA_B, blocks=BLOCKS
                       ) -> List[Tuple[int, int]]:
    """Per channelwise convolution of one clip, the elements of its input
    and of its output: the stem's 5x1x1, then each block's 3x3x3."""
    h1, w1 = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    out = [(base * t * h1 * w1, base * t * h1 * w1)]
    for _, inner, _, _, _, hi, wi, ho, wo in _shapes(t, h, w, base,
                                                      gamma_b, blocks):
        out.append((inner * t * hi * wi, inner * t * ho * wo))
    return out


def channelwise(clips: int, t: int, h: int, w: int, itemsize: int = 2,
                **net) -> int:
    """Bytes of the channelwise convolutions' three passes over ``clips``
    clips of ``t x h x w``, activations of ``itemsize`` bytes."""
    per_clip = sum(i + o for i, o in channelwise_shapes(t, h, w, **net))
    return PASSES * itemsize * clips * per_clip


def itemsize(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4}[dtype]
