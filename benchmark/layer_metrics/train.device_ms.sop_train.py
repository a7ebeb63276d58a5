"""Milliseconds per training step in which the card was busy, in the
cells whose rate is ``sop_train_samples_per_s``: the same reading as
``train.device_ms``, which moves ``train_samples_per_s``."""

from benchmark import harness

read = harness.layer_reader("train.device_ms")
