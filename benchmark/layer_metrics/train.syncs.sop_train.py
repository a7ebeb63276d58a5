"""The same reading as ``train.syncs``, in the cells whose rate is
``sop_train_samples_per_s``."""

from benchmark import harness

read = harness.layer_reader("train.syncs")
