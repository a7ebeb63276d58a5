"""Print a run's best-epoch metrics from its history (reference check_exp.py).

The port's own copy of ``avsep_tpu/check_exp.py``.  As the reference
(check_exp.py:6-15): at the best-AO epoch (argmax of ``val_ao.si_sdr``)
print both branches' sir / SDR / SI-SNR rounded to 2 decimals, then the
same pair at the best-AV epoch.  The run directory is an argument, and a
branch with no evals says so instead of failing on ``argmax([])``.

Usage: python -m avsep_tpu_torch.check_exp ckpt/Exp5_BaseSig
"""

import json
import sys

import numpy as np


def _print_both(history, idx):
    for key, label in (("val_ao", "AO"), ("val_av", "AV")):
        h = history[key]
        if len(h["si_sdr"]) <= idx:
            print(f"{label}: no eval recorded at this epoch")
            continue
        print(f"{label}: sir: {round(h['sir'][idx], 2)}, "
              f"SDR: {round(h['sdr'][idx], 2)}, "
              f"SI-SNR: {round(h['si_sdr'][idx], 2)}")


def main(ckpt_dir: str):
    with open(f"{ckpt_dir}/history_latest.json") as f:
        history = json.load(f)
    for key, title in (("val_ao", "AO"), ("val_av", "AV")):
        h = history[key]
        if not h["si_sdr"]:
            print(f"{key}: no evals recorded")
            continue
        best = int(np.argmax(h["si_sdr"]))
        print(f"Best {title} model (epoch {h['iter'][best]}):")
        _print_both(history, best)
        print("+++++++++++++++++++++++++++++++++++++++++++")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "./ckpt/Exp5_BaseSig")
