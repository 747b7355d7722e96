"""Reference-format accuracy tables: read the artifacts the reference
ships, write ours in the same schema (port of training/accuracy_tables.py,
plain Python, kept as the port's own copy).

The reference stores its step-count robustness sweeps as pickles of
``{"accs": [[acc_per_step...] per model], "steps_arr": [n_steps...]}``
under ``examples/cifar10/checkpoints/accuracy/*.pkl`` (loaded by its
``Evaluate the model.ipynb``).  ``load_accuracy_table`` reads that format;
``save_accuracy_table`` writes ours identically (plus a CSV twin), so a
reference user's analysis notebooks work on its tables and on ours.
"""
from __future__ import annotations

import csv
import os
import pickle
from typing import Dict, Sequence

__all__ = ["load_accuracy_table", "save_accuracy_table"]


def load_accuracy_table(path: str) -> Dict[str, list]:
    """Read a reference-format accuracy pickle.

    Returns ``{"accs": list[list[float]], "steps_arr": list[int]}`` with
    plain Python floats (the reference stores numpy scalars).
    """
    with open(path, "rb") as f:
        d = pickle.load(f)
    if not isinstance(d, dict) or "accs" not in d or "steps_arr" not in d:
        raise ValueError(
            f"{path!r} is not a reference accuracy table "
            "(expected dict with 'accs' and 'steps_arr')"
        )
    accs = [[float(a) for a in row] for row in d["accs"]]
    steps = [int(s) for s in d["steps_arr"]]
    for row in accs:
        if len(row) != len(steps):
            raise ValueError(
                f"row length {len(row)} != steps_arr length {len(steps)}"
            )
    return {"accs": accs, "steps_arr": steps}


def save_accuracy_table(
    path: str,
    accs: Sequence[Sequence[float]],
    steps_arr: Sequence[int],
) -> None:
    """Write an accuracy table in the reference's pickle schema, plus a
    ``<path>.csv`` twin (model row x n_steps column) for spreadsheet use."""
    accs = [[float(a) for a in row] for row in accs]
    steps_arr = [int(s) for s in steps_arr]
    for row in accs:
        if len(row) != len(steps_arr):
            raise ValueError("each accs row must align with steps_arr")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"accs": accs, "steps_arr": steps_arr}, f)
    with open(path + ".csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["model"] + [f"steps_{s}" for s in steps_arr])
        for i, row in enumerate(accs):
            w.writerow([i] + row)
