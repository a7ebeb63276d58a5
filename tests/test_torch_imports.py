"""The port imports nothing of JAX and nothing of the JAX package: every
module of avsep_tpu_torch, and chip_smoke.py, import in a fresh interpreter
where ``jax``, ``flax`` and ``avsep_tpu`` are blocked in ``sys.modules``.
The data-side modules added with ``parallel/`` (``data/scripts/``, the
loader that holds ``ShardDataset``) and the torch-free tools (the set
generator, the loader bench) also import where torch is blocked;
tests/test_torch_data.py checks the rest of the data layer so.  The walk
reaches ``avsep_tpu_torch/tools/`` like every other subpackage, the
measurement and profiling tools among them."""

import os
import pkgutil
import subprocess
import sys

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
import avsep_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
for name in ("jax", "jaxlib", "flax", "avsep_tpu"):
    sys.modules[name] = None          # any import of them raises
import importlib
for mod in sys.argv[1:]:
    importlib.import_module(mod)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "avsep_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok", len(sys.argv) - 1)
"""


def _port_modules():
    mods = ["avsep_tpu_torch"]
    for info in pkgutil.walk_packages(avsep_tpu_torch.__path__,
                                      "avsep_tpu_torch."):
        mods.append(info.name)
    return mods


def test_port_and_chip_smoke_import_without_jax():
    mods = _port_modules() + ["chip_smoke"]
    for name in ("ops.kernels", "engine", "train", "checkpoint",
                 "models.criterion", "models.torch_import", "ops.metrics",
                 "evaluate", "main", "check_exp", "data.dataset",
                 "data.loader", "utils.media", "serve", "separate_cli",
                 "inference", "sop_engine", "sop_main", "models.sop",
                 "models.synthesizer", "models.torch_export",
                 "models.motion", "data.native", "parallel",
                 "parallel.mesh", "parallel.distributed", "parallel.launch",
                 "data.scripts",
                 "data.scripts.post_process_csv", "data.scripts.extract_wav",
                 "data.scripts.extract_optflow",
                 "data.scripts.make_optical_video", "tools",
                 "tools.make_synthetic_data", "tools.av_probe",
                 "tools.sop_probe", "tools.export_reference_ckpt",
                 "tools.schedule_proof", "tools.bench_loader",
                 "tools.measure", "tools.bench", "tools.serve_bench",
                 "tools.latency_report", "tools.train_throughput",
                 "tools.mfu_report", "tools.memory_report",
                 "tools.sep_dtype_ab", "tools.trace_report",
                 "tools.insitu_report"):
        assert f"avsep_tpu_torch.{name}" in mods
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, *mods], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"ok {len(mods)}"


def test_port_sources_do_not_name_the_jax_package_in_imports():
    root = os.path.join(REPO, "avsep_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    for path in files:
        with open(path) as f:
            for line in f:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    words = s.replace(",", " ").split()
                    assert not any(w.split(".")[0] in ("jax", "flax",
                                                       "avsep_tpu")
                                   for w in words[1:2]), (path, s)


_NO_TORCH = """
import sys
for name in ("torch", "jax", "jaxlib", "flax", "avsep_tpu"):
    sys.modules[name] = None          # any import of them raises
import importlib
for mod in sys.argv[1:]:
    importlib.import_module(mod)
print("ok")
"""


def test_data_scripts_and_shard_loader_import_without_torch():
    mods = ["avsep_tpu_torch.data.loader", "avsep_tpu_torch.data.scripts"] + [
        f"avsep_tpu_torch.data.scripts.{m}" for m in (
            "post_process_csv", "extract_wav", "extract_optflow",
            "make_optical_video")] + [
        f"avsep_tpu_torch.tools.{m}" for m in (
            "make_synthetic_data", "bench_loader")]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _NO_TORCH, *mods], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
