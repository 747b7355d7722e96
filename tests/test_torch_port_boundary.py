"""Boundaries of the PyTorch port: it and its examples import neither JAX
(nor orbax or optax) nor the JAX package, its entry points never fall back
to the CPU on their own, and a CPU run launches no kernel."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import neural_ode_metasolver_tpu_torch as pkg
names = [pkg.__name__] + [
    m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "orbax", "optax",
                                    "neural_ode_metasolver_tpu"))
required = {pkg.__name__ + "." + m for m in (
    "ops.noise", "ops.conv3x3", "attacks", "attacks.attacks", "training",
    "training.optimizers", "training.schedules", "training.train",
    "data.datasets", "data.prefetch", "training.checkpoint",
    "runners.common", "runners.mnist_runner", "runners.cifar_runner",
    "runners.attacks_runner", "training.fleet", "runners.sweep",
    "runners.u_sweep", "ops.library", "serving", "data.download",
    "models.torch_export", "models.torch_import", "parallel",
    "parallel.mesh", "parallel.ensemble")}
print(len(names), bad, sorted(required - set(names)))
sys.exit(1 if bad or len(names) < 25 or not required <= set(names) else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of the port in a fresh interpreter; the
    top-level names are compared exactly, since the port's name starts with
    the JAX package's."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT_EXAMPLES = r"""
import glob, importlib.util, os, sys
paths = sorted(glob.glob(os.path.join("examples", "torch", "*.py")))
for path in paths:
    spec = importlib.util.spec_from_file_location(
        "example_" + os.path.basename(path)[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "orbax", "optax",
                                    "neural_ode_metasolver_tpu"))
print(paths, bad)
sys.exit(1 if bad or len(paths) < 3 else 0)
"""


def test_examples_import_neither_jax_nor_the_jax_package():
    """Load every ``examples/torch`` script (its ``main`` is not run) in a
    fresh interpreter: what they import pulls in no JAX."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_EXAMPLES], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """Every import statement of ``chip_smoke.py``, its functions' and its
    subprocess scripts' included, names the port and never JAX or the JAX
    package (the JAX files it names are strings of its report)."""
    import ast
    import re

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    tree = ast.parse(src)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    # the scripts it hands to ``python3 -c`` are strings: their imports too
    for text in (n.value for n in ast.walk(tree)
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)):
        names |= set(re.findall(r"^\s*(?:from|import)\s+(\w+)", text,
                                re.MULTILINE))
    assert "neural_ode_metasolver_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "orbax", "optax",
                        "neural_ode_metasolver_tpu"}, sorted(names)


def test_entry_points_need_a_card_or_an_explicit_cpu():
    from neural_ode_metasolver_tpu_torch import resolve_device
    from neural_ode_metasolver_tpu_torch.models import build_model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path cannot run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("premetanode10", in_planes=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("premetanode10", device="cuda", in_planes=8)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cpu_run_launches_no_kernel():
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import parse_solver_dsl
    from neural_ode_metasolver_tpu_torch.serving import ServedModel

    model = build_model("premetanode10", device="cpu", in_planes=8)
    served = ServedModel(model, parse_solver_dsl("rk2,u,2,-1,0.5,-1"),
                         compute_dtype=torch.bfloat16)
    reset_launch_counts()
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    logits = served(x)
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()
    assert launch_counts() == {}


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """On a CUDA tensor a wrapper launches or raises; these inputs raise
    before any launch (checked on the card by test_torch_cuda.py too)."""
    from neural_ode_metasolver_tpu_torch import _build

    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_cuda_tensors("k", torch.float32, x=x)
    with pytest.raises(TypeError):
        _build.check_cuda_tensors("k", torch.float16, x=x.half())
