"""The same reading as ``train.host_ms``, in the cells whose rate is
``sop_train_samples_per_s``."""

from benchmark import harness

read = harness.layer_reader("train.host_ms")
