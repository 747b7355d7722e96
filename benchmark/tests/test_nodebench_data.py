"""The harness takes new cells as data: every cell of BENCHMARK.json
resolves to its files by name, and a configuration, traffic mix, cell and
metric dropped into a copy are found with no edit of a file that is
there."""
import json
import os
import shutil
from types import SimpleNamespace

import pytest

from benchmark.harness import cell as cellmod
from conftest import ROOT

BENCH = cellmod.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    c = cellmod.resolve(name, ROOT)
    assert c.driver().setup and c.driver().check
    assert c.limits and c.launches
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(c.metric_reader(m["name"]).read)
    for m in c.per_layer:
        assert m["moves"] in reported


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_a_configuration_builds_the_port_with_its_own_widths(name):
    """The port's ``build`` arguments repeat the widths the reference reads,
    number for number, and lists reach the builder as tuples."""
    from benchmark.harness import port

    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = cellmod.load_json(os.path.join(ROOT, entry["file"]))
    shared = set(cfg["build"]) & set(cfg)
    assert shared and all(cfg["build"][k] == cfg[k] for k in shared)
    kw = port.build_kwargs(cfg, "GeLU")
    assert not any(isinstance(v, list) for v in kw.values())
    for key, copies in cfg.get("build_activation", {}).items():
        assert kw[key] == ("GeLU",) * copies


def test_per_layer_metrics_name_their_cells_and_metric():
    cells = set(CELLS)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_a_dropped_in_cell_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "premetanode10.json").read_text())
    cfg["in_planes"] = cfg["build"]["in_planes"] = 96
    (b / "configs" / "wide10.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "serve.b256.json").read_text())
    mix["batch"] = 64
    (b / "traffic" / "serve.b64.json").write_text(json.dumps(mix))
    (b / "cells" / "wide10.serve.b64.json").write_text(json.dumps(
        {"limits": {"logit_gap": 0.1}, "launches": {"ode_block_rk2": 66}}))
    (b / "metrics" / "requests.serve.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    bench["configs"].append({"name": "wide10", "source": "x",
                             "file": "benchmark/configs/wide10.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "wide10.serve.b64", "config": "wide10",
                               "traffic": "serve.b64", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("wide10.serve.b64")
    bench["per_layer"].append({"name": "requests.serve", "unit": "req",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "serve_img_per_s",
                               "workloads": ["wide10.serve.b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cellmod.resolve("wide10.serve.b64", str(root))
    assert c.config["in_planes"] == 96 and c.traffic["batch"] == 64
    assert [m["name"] for m in c.per_layer][-1] == "requests.serve"
    assert c.metric_reader("requests.serve").read(
        SimpleNamespace(units=7)) == 7.0
    assert {m["name"] for m in c.end_to_end} == {
        "serve_img_per_s", "serve_p95_ms", "setup_s"}


def test_a_dropped_in_kernel_pattern_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pats = root / "benchmark" / "kernels" / "patterns"
    pats.mkdir(exist_ok=True)
    name = "void nodems::conv3x3_wide_kernel<0>(nodems::ConvArgs)"
    assert cellmod.classify(name, cellmod.kernel_classes(str(root))) is None
    (pats / "b1_wide.json").write_text(json.dumps(
        {"class": "b1", "patterns": ["conv3x3_wide_kernel"]}))
    assert cellmod.classify(name, cellmod.kernel_classes(str(root))) == "b1"
