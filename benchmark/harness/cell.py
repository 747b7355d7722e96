"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root
names the cell's configuration and traffic; the files are

  benchmark/configs/<config>.json     (the path ``BENCHMARK.json`` gives)
  benchmark/traffic/<traffic>.json    the mix's parameters and its driver
  benchmark/cells/<cell>.json         the limits of ``correct`` and the
                                      launches a unit of work makes
  benchmark/drivers/<driver>.py       the generator and loop of a kind of
                                      traffic
  benchmark/metrics/<metric>.py       one reader per per-layer metric
  benchmark/kernels/<class>.py        a kernel class: the work it owns and
                                      the kernel names that time it
  benchmark/kernels/patterns/*.json   further kernel names of a class

so a new cell, configuration, mix or metric is a new file and an entry,
and no edit.
"""
from __future__ import annotations

import glob
import importlib
import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: Optional[str] = None) -> ModuleType:
    """The Python file ``path`` as a module (loaded once per name)."""
    name = name or "nodebench_" + re.sub(r"\W", "_", os.path.relpath(
        path, ROOT))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    root: str
    spec: dict
    config: dict
    traffic: dict
    limits: dict
    launches: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.spec.get("chips", 1))

    def driver(self) -> ModuleType:
        return importlib.import_module("benchmark.drivers."
                                       + self.traffic["driver"])

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(os.path.join(self.root, "benchmark", "metrics",
                                        name + ".py"))


def _for_cell(metrics: List[dict], cell: str, reported: set) -> List[dict]:
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m.get("moves", m["name"]) in reported:
            out.append(m)
    return out


def resolve(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; raises
    KeyError when there is no such cell or a file it names is missing."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    specs = {w["name"]: w for w in bench["workloads"]}
    if name not in specs:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(specs)})")
    spec = specs[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(load_json(os.path.join(root, configs[spec["config"]]
                                         ["file"])))
    config["name"] = spec["config"]
    traffic = load_json(os.path.join(root, "benchmark", "traffic",
                                     spec["traffic"] + ".json"))
    cell_file = load_json(os.path.join(root, "benchmark", "cells",
                                       name + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    per_layer = _for_cell(bench["per_layer"], name,
                          {m["name"] for m in e2e})
    return Cell(name=name, root=root, spec=spec, config=config,
                traffic=traffic, limits=cell_file["limits"],
                launches=cell_file.get("launches", {}), end_to_end=e2e,
                per_layer=per_layer)


@dataclass
class KernelClass:
    """A kernel class: its module (``claims``, ``least_seconds``), its
    precedence and its compiled name patterns."""

    name: str
    priority: int
    module: ModuleType
    patterns: List[re.Pattern]

    def matches(self, kernel: str) -> bool:
        return any(p.search(kernel) for p in self.patterns)


def kernel_classes(root: str = ROOT) -> List[KernelClass]:
    """Every ``benchmark/kernels/<class>.py``, lowest ``PRIORITY`` first,
    with the patterns of ``benchmark/kernels/patterns/*.json`` added to the
    class each names."""
    kdir = os.path.join(root, "benchmark", "kernels")
    extra: Dict[str, List[str]] = {}
    for path in sorted(glob.glob(os.path.join(kdir, "patterns", "*.json"))):
        entry = load_json(path)
        extra.setdefault(entry["class"], []).extend(entry["patterns"])
    out = []
    for path in sorted(glob.glob(os.path.join(kdir, "*.py"))):
        mod = load_module(path)
        name = os.path.basename(path)[:-3]
        pats = list(getattr(mod, "PATTERNS", ())) + extra.get(name, [])
        out.append(KernelClass(name, int(getattr(mod, "PRIORITY", 50)), mod,
                               [re.compile(p) for p in pats]))
    return sorted(out, key=lambda k: (k.priority, k.name))


def classify(kernel: str, classes: List[KernelClass]) -> Optional[str]:
    """The first class (by precedence) whose patterns match the kernel's
    name, else None."""
    for k in classes:
        if k.matches(kernel):
            return k.name
    return None
