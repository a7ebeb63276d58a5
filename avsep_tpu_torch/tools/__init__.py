"""The proof, checkpoint and measurement tools, each run as ``python -m
avsep_tpu_torch.tools.<name>`` (the names of the JAX package's ``tools/``
and ``examples/`` scripts and of ``bench.py``):

* ``make_synthetic_data``: the class-token synthetic set (torch-free);
* ``av_probe``: permutation accuracy, the pointing game and AV / AO
  SI-SDR of a CoLoc checkpoint;
* ``sop_probe``: the frames-swap assignment accuracy of a SoP++
  checkpoint;
* ``export_reference_ckpt``: a checkpoint to the reference's ``.pth``
  files (on the CPU);
* ``schedule_proof``: the learning-rate schedule across a resume;
* ``bench_loader``: the host loader's rate (torch-free);
* ``bench``: batched separation clips/s, ``bench.py``'s JSON line;
* ``serve_bench``: the service's req/s and latency under closed-loop
  clients;
* ``latency_report``: one clip's device time and the batching knee;
* ``train_throughput``: AV train steps/s;
* ``mfu_report``: FLOPs from shapes and the MFU share of the card's peak;
* ``memory_report``: peak memory per batch and the largest that fits;
* ``sep_dtype_ab``: float32 against bfloat16 separation;
* ``trace_report``: the AV train step's device time by op category under
  ``torch.profiler``, its top kernels and the busy share of the wall;
* ``insitu_report``: a train step split into the device floor (a CUDA
  graph's replay), the dispatch cost and the host data cost not hidden.

``measure`` holds what the measurement tools share.

Every one but the export and the two torch-free tools runs on ``cuda``
unless its function is given ``device="cpu"``, and raises without a GPU;
``memory_report`` measures a card only.
"""
