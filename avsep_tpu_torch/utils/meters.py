"""Running meters and the training history (reference utils.py:39-78,
main.py:668-674).  The port's own copy of ``avsep_tpu/utils/meters.py``."""

from __future__ import annotations

import numpy as np


class AverageMeter:
    """Weighted running average (drop-in for reference utils.AverageMeter)."""

    def __init__(self):
        self.initialized = False
        self.val = None
        self.sum = None
        self.count = None
        self.avg = None

    def initialize(self, val, weight):
        self.val = np.asarray(val)
        self.sum = np.asarray(val) * weight
        self.count = weight
        self.avg = np.asarray(val)
        self.initialized = True

    def update(self, val, weight=1):
        if not self.initialized:
            self.initialize(val, weight)
        else:
            val = np.asarray(val)
            self.val = val
            self.sum = self.sum + val * weight
            self.count += weight
            self.avg = self.sum / self.count

    def value(self):
        return 0.0 if self.val is None else self.val.tolist()

    def average(self):
        return 0.0 if self.avg is None else self.avg.tolist()


def new_history() -> dict:
    """The training/eval history dict layout (reference main.py:668-674)."""
    return {
        "train": {"iter": [], "err": []},
        "train_ao": {"iter": [], "err": []},
        "train_av": {"iter": [], "err": []},
        "val_av": {"iter": [], "err": [], "sdr": [], "sir": [], "sar": [],
                   "si_sdr": []},
        "val_ao": {"iter": [], "err": [], "sdr": [], "sir": [], "sar": [],
                   "si_sdr": []},
    }
