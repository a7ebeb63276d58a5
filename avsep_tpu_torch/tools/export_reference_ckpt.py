"""Export a port checkpoint to the reference's ``.pth`` files.

Port of ``tools/export_reference_ckpt.py``, and the inverse of the
``--weights_sound`` / ``--weights_frame`` import: writes
``{sound,frame}_{tag}.pth`` (and ``synthesizer_{tag}.pth`` for a SoP++
checkpoint) in the reference's per-net ``state_dict`` layout (reference
``main.py:506-533``), so a model trained on the port drops into the
reference's eval and demo scripts (``main.py:789-793``).

Usage (the training flags, so the nets are rebuilt as they were trained)::

    python -m avsep_tpu_torch.tools.export_reference_ckpt --id Exp5 \\
        --ckpt ./ckpt --arch_sound unet7 --fusion_type hidsep ... \\
        [--tag best|latest] [--out DIR] [--sop]

It reads ``<ckpt>/<id>/state_{tag}.pt`` and writes into ``--out`` (default
that directory).  It does no arithmetic: it builds the nets on the CPU,
reads the checkpoint onto the CPU and renames keys
(``models/torch_export.py``), so it is the one tool that needs no GPU.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence


def export(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Run the tool on ``argv`` (``sys.argv[1:]`` when None); returns the
    paths it wrote."""
    import torch

    from avsep_tpu_torch import checkpoint
    from avsep_tpu_torch.config import parse_args
    from avsep_tpu_torch.models.torch_export import (
        resnet_to_torch, save_torch_checkpoint, synthesizer_to_torch,
        unet_to_torch)

    # the tool's own flags; everything else is the Config command line, so
    # the nets are rebuilt exactly as trained
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--tag", default="best", choices=("best", "latest"))
    ap.add_argument("--out", default="")
    ap.add_argument("--sop", action="store_true",
                    help="SoP++ checkpoint (sound/frame/synthesizer nets)")
    tool_args, rest = ap.parse_known_args(argv)

    cfg = parse_args(rest)
    ckpt_dir = os.path.join(cfg.ckpt, cfg.id)
    out_dir = tool_args.out or ckpt_dir
    os.makedirs(out_dir, exist_ok=True)

    gen = torch.Generator().manual_seed(cfg.seed)
    if tool_args.sop:
        from avsep_tpu_torch.sop_main import build_sop_nets, init_sop_state
        state = init_sop_state(cfg, build_sop_nets(cfg, device="cpu"), gen,
                               device="cpu")
    else:
        from avsep_tpu_torch.engine import build_nets
        from avsep_tpu_torch.train import init_state
        state = init_state(cfg, build_nets(cfg, device="cpu"), gen,
                           device="cpu")
    nets = checkpoint.restore_checkpoint(ckpt_dir, state, tool_args.tag).nets

    sds = {"sound": unet_to_torch(nets.sound.state_dict(),
                                  num_downs=int(cfg.arch_sound[-1])),
           "frame": resnet_to_torch(nets.frame.state_dict())}
    if getattr(nets, "synthesizer", None) is not None:
        sds["synthesizer"] = synthesizer_to_torch(
            nets.synthesizer.state_dict())
    wrote = []
    for name, sd in sds.items():
        path = os.path.join(out_dir, f"{name}_{tool_args.tag}.pth")
        save_torch_checkpoint(sd, path)
        wrote.append(path)
        print("wrote", path)
    return wrote


if __name__ == "__main__":
    export()
