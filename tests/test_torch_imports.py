"""The port imports nothing of JAX and nothing of the JAX package: every
module of avsep_tpu_torch, and chip_smoke.py, import in a fresh interpreter
where ``jax``, ``flax`` and ``avsep_tpu`` are blocked in ``sys.modules``."""

import os
import pkgutil
import subprocess
import sys

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
                 "data.loader", "utils.media"):
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
