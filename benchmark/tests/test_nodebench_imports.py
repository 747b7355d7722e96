"""The import boundary: in a fresh process, the harness, its drivers,
readers and kernel classes, the reference and a whole run (on the CPU, at
a test's size) load no module whose top-level name is jax, jaxlib, flax or
the JAX package; and the reference alone loads nothing of the port."""
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "neural_ode_metasolver_tpu")

_RUN = f"""
import json, os, sys
sys.path[:0] = [{ROOT!r}, os.path.join({ROOT!r}, "benchmark", "tests")]
import torch
from benchmark.harness import cell as cellmod
from conftest import tiny
sys.path.insert(0, os.path.join({ROOT!r}, "benchmark"))
import run
for name in ("premetanode10.serve.b256", "mnist_metanode64.fleet27.clean"):
    c = tiny(cellmod.resolve(name, {ROOT!r}))
    for m in c.end_to_end + c.per_layer:
        c.metric_reader(m["name"])
    cellmod.kernel_classes({ROOT!r})
    assert run.run_cell(c, 7, 0.2, False, torch.device("cpu")) is not None
print(json.dumps(sorted(sys.modules)))
"""

_REFERENCE = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
from benchmark.reference import cifar_prebasic, mnist_metanode, training
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_nothing_of_jax():
    mods = _modules(_RUN)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & set(FORBIDDEN), sorted(tops & set(FORBIDDEN))
    assert "neural_ode_metasolver_tpu_torch" in tops


def test_the_reference_loads_nothing_of_the_port():
    tops = {m.split(".")[0] for m in _modules(_REFERENCE)}
    assert not tops & (set(FORBIDDEN) | {"neural_ode_metasolver_tpu_torch"})
