"""The port's u-sweep CLI (``runners/u_sweep.py``) on the CPU, the cases of
``tests/test_runners.py``'s u-sweep tests: end to end, ``--fleet`` against
the sequential sweep, oversized grids auto-chunked with a padded tail, and
the CSV's columns equal to JAX's."""
import csv
import logging

import pytest

from neural_ode_metasolver_tpu.runners import u_sweep as j_u_sweep
from neural_ode_metasolver_tpu_torch.runners import u_sweep
from tests.test_torch_runners import one_torch_thread  # noqa: F401

TINY = ["--n_steps", "2", "--batch_size", "16", "--dim", "8",
        "--device", "cpu"]


def _rows(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_u_sweep_end_to_end_columns_equal_jax(tmp_path):
    """Two u values, one seed, on synthetic data: the CSV has JAX's
    header and a row per (u, seed)."""
    out_csv = str(tmp_path / "usweep.csv")
    u_sweep.main(["--u_grid", "0.5,1.0", "--seeds", "1", "--nepochs", "1",
                  "--synthetic_train_size", "32",
                  "--synthetic_test_size", "16", "--output_csv", out_csv]
                 + TINY)
    header, rows = _rows(out_csv)
    jax_out = str(tmp_path / "jax.csv")
    j_u_sweep._write_csv(jax_out, [])
    assert header == _rows(jax_out)[0] == u_sweep.CSV_COLUMNS
    assert len(rows) == 2 and {r["u0"] for r in rows} == {"0.5", "1.0"}
    for r in rows:
        assert 0.0 <= float(r["clean_acc"]) <= 1.0
        assert 0.0 <= float(r["robust_acc"]) <= 1.0


def test_u_sweep_fleet_matches_sequential(tmp_path):
    """--fleet (one fleet of 4, and two of 2 with --fleet_chunk 2) against
    the sequential sweep: each member's clean accuracy within 3/32 (its
    params follow its run to float tolerance, so only borderline samples
    may flip), robust accuracy in [0, 1]."""
    common = ["--u_grid", "0.35,1.0", "--seeds", "1,2", "--nepochs", "2",
              "--pgd_niter", "2", "--synthetic_train_size", "64",
              "--synthetic_test_size", "32"] + TINY
    seq_csv = str(tmp_path / "seq.csv")
    u_sweep.main(common + ["--output_csv", seq_csv])
    seq = {(r["u0"], r["seed"]): r for r in _rows(seq_csv)[1]}
    for extra in ([], ["--fleet_chunk", "2"]):
        fleet_csv = str(tmp_path / f"fleet{len(extra)}.csv")
        u_sweep.main(common + ["--fleet", "--output_csv", fleet_csv] + extra)
        fleet = {(r["u0"], r["seed"]): r for r in _rows(fleet_csv)[1]}
        assert set(fleet) == set(seq) and len(fleet) == 4
        for k in seq:
            d = abs(float(fleet[k]["clean_acc"])
                    - float(seq[k]["clean_acc"]))
            assert d <= 3 / 32, (k, fleet[k], seq[k])
            assert 0.0 <= float(fleet[k]["robust_acc"]) <= 1.0


def test_u_sweep_fleet_oversized_auto_chunks(monkeypatch):
    """Member counts above FLEET_SAFE_CHUNK chunk into equal fleets, a
    short tail padded with copies of its first member (dropped from the
    rows); --fleet_chunk is honoured and must be >= 1."""
    calls = []

    def fake_members(args, dev, opt, ref_solver, opts, train_attack,
                     pgd_attack, train_ds, test_ds, logger, members):
        calls.append(list(members))
        return [{"u0": u, "seed": s, "clean_acc": 1.0, "robust_acc": 1.0}
                for (u, s) in members]

    monkeypatch.setattr(u_sweep, "_run_fleet_members", fake_members)
    monkeypatch.setattr(u_sweep, "FLEET_SAFE_CHUNK", 16)
    logger = logging.getLogger("test_torch_u_sweep")

    def run(u_grid, seeds, fleet_chunk):
        calls.clear()
        args = u_sweep.parse_args(
            ["--u_grid", ",".join(str(u) for u in u_grid),
             "--seeds", ",".join(str(s) for s in seeds), "--fleet"]
            + (["--fleet_chunk", str(fleet_chunk)]
               if fleet_chunk is not None else []))
        return u_sweep._run_fleet(args, None, None, None, None, None, None,
                                  None, None, logger)

    rows = run([0.1, 0.3, 0.5, 0.7, 0.9], [1, 2, 3, 4], None)
    assert [len(c) for c in calls] == [10, 10] and len(rows) == 20
    assert len({(r["u0"], r["seed"]) for r in rows}) == 20
    rows = run([0.1, 0.3, 0.5, 0.7], list(range(1, 25)), None)
    assert [len(c) for c in calls] == [16] * 6 and len(rows) == 96
    rows = run([0.5], list(range(1, 18)), None)
    assert [len(c) for c in calls] == [9, 9]
    assert len(set(calls[1])) == 8 and calls[1][-1] == calls[1][0]
    assert len({(r["u0"], r["seed"]) for r in rows}) == 17
    for bad in (0, -4):
        with pytest.raises(ValueError, match="fleet_chunk"):
            run([0.5], [1, 2], bad)
    rows = run([0.1, 0.3, 0.5, 0.7, 0.9], [1, 2, 3, 4], 8)
    assert [len(c) for c in calls] == [8, 8, 8] and len(rows) == 20
    rows = run([0.1, 0.3], [1, 2, 3, 4], None)
    assert [len(c) for c in calls] == [8] and len(rows) == 8
