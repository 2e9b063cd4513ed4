"""The port's import boundary.

``llmd_kv_cache_tpu_torch`` and ``chip_smoke.py`` run where there is no
JAX, ``ml_dtypes``, ``msgpack``, ``zmq``, ``prometheus_client``, ``boto3``,
``transformers``, ``safetensors`` or ``orbax``: importing every port module
in a fresh interpreter must leave JAX, those packages and the JAX package
(``llmd_kv_cache_tpu``, whose name the port's own name starts with) out of
``sys.modules``. (The port reads checkpoints with code of its own.)
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
import llmd_kv_cache_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
banned = ("jax", "jaxlib", "ml_dtypes", "msgpack", "zmq", "prometheus_client",
          "boto3", "transformers", "safetensors", "orbax", "llmd_kv_cache_tpu")
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in banned))
print(len(names), leaked)
"""


def test_port_imports_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, leaked = out.stdout.split(" ", 1)
    assert int(n_modules) >= 20  # every subpackage and module was imported
    assert leaked.strip() == "[]"
