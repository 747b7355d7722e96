"""The control comes out not correct: the reference computed in the
precision below the configuration's (fp8 for bfloat16: every held tensor
and operand; TF32 for float32), put in the program's place, fails one of
the cell's limits,
while the program at the same size passes them.  On the card, at the
cells' widths with fewer images (``benchmark/control.py`` reads the same
at the cells' own size)."""
import os
import sys

import pytest

from benchmark.harness import cell as cellmod
from benchmark.harness import compare
from conftest import ROOT

sys.path.insert(0, os.path.join(ROOT, "benchmark"))
import control  # noqa: E402

CELLS = ["premetanode10.advtrain.b256", "mnist_metanode64.fleet27.clean",
         "premetanode10.serve.b256"]


def _small(name):
    c = cellmod.resolve(name, ROOT)
    c.traffic = dict(c.traffic, batch=32, pool=4)
    if "members" in c.traffic:
        c.traffic.update(members=3, member_u=c.traffic["member_u"][::9])
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    c = _small(name)
    for seed in (2147483911, 2147483912, 2147483913):
        ok, checks = compare.judge(
            control.readings(c, seed, "program", card, 0.5), c.limits)
        assert ok, checks
        ok, checks = compare.judge(
            control.readings(c, seed, "control", card), c.limits)
        assert not ok, checks
