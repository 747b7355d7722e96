"""Shared pieces of the benchmark's tests: the checkout's root on the path,
and cells cut to a size the CPU runs in seconds."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny(cell):
    """``cell`` cut to a CPU test's size: narrow nets, two RK steps, four
    images, three fleet members (one of each u); no launch is expected on
    the CPU."""
    cfg, tr = dict(cell.config), dict(cell.traffic)
    cfg["build"] = dict(cfg["build"])
    for key in ("in_planes", "dim"):
        if key in cfg:
            cfg[key] = cfg["build"][key] = 8
    cfg["solver"] = dict(cfg["solver"], n_steps=2)
    tr.update(batch=4, pool=4, trace_units=2)
    if "members" in tr:
        tr.update(members=3, member_u=tr["member_u"][::9])
    if "warm_requests" in tr:
        tr["warm_requests"] = 1
    cell.config, cell.traffic, cell.launches = cfg, tr, {}
    return cell


@pytest.fixture
def tiny_cell():
    from benchmark.harness import cell as cellmod

    return lambda name: tiny(cellmod.resolve(name, ROOT))


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
