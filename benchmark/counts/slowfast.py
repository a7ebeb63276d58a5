"""FLOPs of SlowFast R50's slow pathway and its laterals, counted from a
configuration's shapes by ``counts/flops.py``'s rules: every
convolution's 2 x multiply-adds; a trained convolution counts its
forward, its weight gradient, and its input gradient where the input takes
one (not the stem, whose input is data).  With ``flops.resnet3d_fast`` and
the ``fc`` they equal ``torch.utils.flop_counter`` on the plain reference
(``benchmark/reference/slowfast.py``; ``benchmark/tests/
test_benchmark_slowfast.py``).

The slow pathway reads every ``speed``-th frame, ``ceil(t / speed)`` of
``t``; each lateral is a ``kernel`` x1x1 convolution at temporal stride
``speed`` from the fast map (C -> 2C), whose output the slow pathway's
next stage takes as more input channels.
"""

from __future__ import annotations

from typing import List

from benchmark.counts.flops import Conv, _out, conv3d_flops

BLOCKS = (3, 4, 6, 3)
INFLATE = (False, False, True, True)


def _fast_widths(fast: int, blocks) -> List[int]:
    """The fast pathway's widths after its stem and after each stage."""
    return [fast] + [fast * 4 * 2 ** i for i in range(len(blocks))]


def slow_pathway(b: int, t: int, h: int, w: int, base: int = 64,
                 fast: int = 8, blocks=BLOCKS, inflate=INFLATE,
                 speed: int = 8) -> List[Conv]:
    """The slow pathway on ``[b, 3, t, h, w]`` clips: the 1x7x7 stem at
    stride (1, 2, 2) on ``ceil(t / speed)`` frames (no input gradient), a
    (1, 3, 3) max-pool at stride (1, 2, 2), then bottlenecks whose
    ``conv1`` is 3x1x1 where ``inflate`` is on and 1x1x1 elsewhere, each
    stage's input widened by the lateral before it."""
    ts = -(-t // speed)
    laterals = [2 * c for c in _fast_widths(fast, blocks)[:len(blocks)]]
    out: List[Conv] = []
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    out.append((conv3d_flops(b, 3, base, 1, 7, 7, ts, h, w), False))
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)            # max-pool
    cin = base
    for stage, n in enumerate(blocks):
        cin += laterals[stage]
        planes = base * 2 ** stage
        kt = 3 if inflate[stage] else 1
        for block in range(n):
            s = 2 if stage > 0 and block == 0 else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            out.append((conv3d_flops(b, cin, planes, kt, 1, 1, ts, h, w),
                        True))
            out.append((conv3d_flops(b, planes, planes, 1, 3, 3, ts, ho, wo),
                        True))
            out.append((conv3d_flops(b, planes, 4 * planes, 1, 1, 1, ts, ho,
                                     wo), True))
            if s != 1 or cin != 4 * planes:
                out.append((conv3d_flops(b, cin, 4 * planes, 1, 1, 1, ts, ho,
                                         wo), True))
            h, w, cin = ho, wo, 4 * planes
    return out


def laterals(b: int, t: int, h: int, w: int, fast: int = 8, blocks=BLOCKS,
             speed: int = 8, kernel: int = 5) -> List[Conv]:
    """The lateral convolutions, after the fast stem's max-pool and after
    each stage but the last: ``kernel`` x1x1 at temporal stride ``speed``,
    C -> 2C, each input the fast map (it takes a gradient)."""
    ts = _out(t, kernel, speed, kernel // 2)
    h, w = _out(_out(h, 7, 2, 3), 3, 2, 1), _out(_out(w, 7, 2, 3), 3, 2, 1)
    out: List[Conv] = []
    for stage, c in enumerate(_fast_widths(fast, blocks)[:len(blocks)]):
        if stage > 1:                     # stages 2 and 3 halve the map
            h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
        out.append((conv3d_flops(b, c, 2 * c, kernel, 1, 1, ts, h, w), True))
    return out
