"""A run on a machine with no card fails, prints no result and never falls
back to the CPU."""
import subprocess
import sys

import pytest

from conftest import ROOT


def test_run_without_a_card_exits_2_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "premetanode10.serve.b256", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
