"""Share of the profiled training stretch in which no kernel ran on the
card, in the cells whose rate is ``sop_train_samples_per_s``: the same
reading as ``device_idle.train``, which moves ``train_samples_per_s``."""

from benchmark import harness

read = harness.layer_reader("device_idle.train")
