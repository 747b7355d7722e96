"""A run with its timed path broken underneath comes out not correct: the
harness is driven past its look for a chip (on the CPU, at a test's size)
with one planted fault each: a step that leaves its state unchanged, half
of the batch left out (the mean taken over the rest), an answer altered
where it is produced.  The same run unbroken comes out correct where the
CPU's path agrees with the card's; the flagship's bfloat16 path at width 8
on the CPU reads its loss further from the float32 reference (3e-5 to
1.5e-4 over four seeds) than the card's at full width does (at most 2e-5),
so its unbroken run is judged on the card only (``benchmark/control.py``).
"""
import os
import sys

import pytest
import torch
import torch.nn.functional as F

from conftest import ROOT

sys.path.insert(0, os.path.join(ROOT, "benchmark"))
import run  # noqa: E402

TRAIN = ["premetanode10.advtrain.b256", "mnist_metanode64.fleet27.clean"]
SERVE = "premetanode10.serve.b256"
SEED = 2147483901


def _run(cell):
    return run.run_cell(cell, SEED, 0.3, False, torch.device("cpu"))


def _unchanged(monkeypatch):
    from neural_ode_metasolver_tpu_torch.training import optimizers

    monkeypatch.setattr(optimizers._Rule, "update",
                        lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    from neural_ode_metasolver_tpu_torch.attacks import attacks

    def half(logits, y):
        n = y.shape[-1] // 2
        if logits.dim() == 3:
            return half_members(logits, y).sum()
        return F.cross_entropy(logits[:n], y[:n])

    def half_members(logits, y):
        n = y.shape[-1] // 2
        s, _, k = logits.shape
        return F.cross_entropy(logits[:, :n].reshape(-1, k),
                               y[:, :n].reshape(-1),
                               reduction="none").reshape(s, n).mean(1)

    monkeypatch.setattr(attacks, "cross_entropy", half)
    monkeypatch.setattr(attacks, "member_cross_entropy", half_members)


def _altered(monkeypatch):
    from neural_ode_metasolver_tpu_torch import serving

    logits = serving.ServedModel.logits

    def altered(self, x):
        z = logits(self, x).clone()
        z[0] = z[0].flip(-1)
        return z

    monkeypatch.setattr(serving.ServedModel, "logits", altered)


@pytest.mark.parametrize("name", TRAIN[1:] + [SERVE])
def test_an_unbroken_run_is_correct(tiny_cell, name):
    r = _run(tiny_cell(name))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_train_step_is_not_correct(tiny_cell, monkeypatch, name,
                                            fault):
    fault(monkeypatch)
    r = _run(tiny_cell(name))
    assert r is not None and not r["correct"], r["checks"]


def test_an_altered_answer_is_not_correct(tiny_cell, monkeypatch):
    _altered(monkeypatch)
    r = _run(tiny_cell(SERVE))
    assert not r["correct"], r["checks"]
