"""The proof and checkpoint tools, each run as ``python -m
avsep_tpu_torch.tools.<name>`` (the names of the JAX package's ``tools/``
and ``examples/`` scripts):

* ``make_synthetic_data``: the class-token synthetic set (torch-free);
* ``av_probe``: permutation accuracy, the pointing game and AV / AO
  SI-SDR of a CoLoc checkpoint;
* ``sop_probe``: the frames-swap assignment accuracy of a SoP++
  checkpoint;
* ``export_reference_ckpt``: a checkpoint to the reference's ``.pth``
  files (on the CPU);
* ``schedule_proof``: the learning-rate schedule across a resume;
* ``bench_loader``: the host loader's rate (torch-free).

Every one but the export and the two torch-free tools runs on ``cuda``
unless its function is given ``device="cpu"``, and raises without a GPU.
"""
