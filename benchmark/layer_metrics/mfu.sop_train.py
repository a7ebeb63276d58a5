"""The whole training step's share of the card's published peak, in the
cells whose rate is ``sop_train_samples_per_s``: the same reading as
``mfu.train``, which moves ``train_samples_per_s``."""

from benchmark import harness

read = harness.layer_reader("mfu.train")
