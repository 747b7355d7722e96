"""Checkpoint / resume (port of training/checkpoint.py).

One checkpoint is ``base/step_%08d/{state, config.json}``: ``state`` holds
the whole TrainState (step, params by name, optimizer state, the model
state's buffers by name: BN running statistics, SN vectors), written with
``torch.save`` to a temporary name and then renamed, and that rename is the
commit, as orbax's is, so ``latest_step`` counts only steps whose ``state``
exists.  The sidecar is ``json.dump(config, indent=2, default=str)`` with
the JAX package's schema (the runner args under ``"args"``, the solver
DSL, the model name), from which evaluation rebuilds model, solvers and
optimizer as ``attacks_runner.py:65`` does.

``save_checkpoint(..., block=False)`` copies the tensors to the host before
it returns (so the train step may update them in place right after) and
writes on one background thread, in the order of the calls;
``wait_for_checkpoints()`` waits for every write.  The caller's part of a
save (the gather, the copies to the host and a blocking write) is the span
``checkpoint.save`` (``backend.span``).  ``restore_checkpoint``
copies the saved values into a target state's tensors in place, on the
target's devices (the model's own parameters and buffers, so the model
sees them), bit for bit.  In a process group of several ranks (data
parallelism, ``parallel/mesh.py``) rank 0 alone writes, and its write
blocks, so a barrier after the save means the checkpoint is committed;
the other ranks return the path at once; every rank can restore.  Under
tensor parallelism every rank calls the save, which gathers the
tp-sharded params and their optimizer mirrors first: the checkpoint is
the global tree; a target holding tp slices restores its slices of it.  A state that extends ``TrainState`` with more
fields (a trainable solver's u and v and their optimizer's state, which JAX
writes under ``save_dir/solver_trained``) saves and restores each of them
the same way, as a tree of tensors and numbers.
"""
from __future__ import annotations

import json
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import fields, replace
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..backend import spanned
from ..parallel.mesh import map_tp_state, rank, world_size
from .train import TrainState, load_opt_state

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "load_checkpoint_config",
    "latest_step",
    "wait_for_checkpoints",
]

_writer: Optional[ThreadPoolExecutor] = None
_pending: List[Future] = []
_lock = threading.Lock()


def _ckpt_dir(base: str, step: int) -> str:
    return os.path.join(os.path.abspath(base), f"step_{step:08d}")


def _to_host(tree: Any) -> Any:
    """Nested dicts and lists of tensors and numbers with every tensor
    copied to the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v) for v in tree]
    return tree


def _extra_fields(ts: TrainState) -> List[str]:
    """The fields a subclass of ``TrainState`` adds to it."""
    base = {f.name for f in fields(TrainState)}
    return [f.name for f in fields(ts) if f.name not in base]


def _write_state(path: str, payload: dict) -> None:
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, "state")
    tmp = f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, final)


@spanned("checkpoint.save")
def save_checkpoint(
    base_dir: str,
    ts: TrainState,
    config: Optional[Dict[str, Any]] = None,
    block: bool = True,
) -> str:
    """Write one checkpoint (+ config sidecar) for ``ts``'s step; returns
    its directory."""
    global _writer
    step = int(ts.step)
    path = _ckpt_dir(base_dir, step)
    # the global tree: tp slices gathered (every rank takes part)
    params, opt_state = map_tp_state(ts.params, ts.params, ts.opt_state,
                                     lambda _, rule, t: rule.gather(t))
    if world_size() > 1:
        if rank() != 0:
            return path
        block = True
    payload = {"step": step, "params": _to_host(params),
               "opt_state": _to_host(opt_state),
               "model_state": _to_host(ts.model_state)}
    payload.update({name: _to_host(getattr(ts, name))
                    for name in _extra_fields(ts)})
    if config is not None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
    if block:
        _write_state(path, payload)
        return path
    with _lock:
        if _writer is None:
            _writer = ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="checkpoint")
        _pending.append(_writer.submit(_write_state, path, payload))
    return path


def wait_for_checkpoints() -> None:
    """Block until every ``save_checkpoint(..., block=False)`` has
    committed; raise the first write's error, if any."""
    with _lock:
        pending = list(_pending)
        _pending.clear()
    for fut in pending:
        fut.result()


def latest_step(base_dir: str) -> Optional[int]:
    """Newest committed step: a step dir counts only once its ``state``
    exists, so a crash between a sidecar and its state's commit cannot
    shadow the older complete checkpoint for ``--resume``."""
    if not os.path.isdir(base_dir):
        return None
    steps = []
    for name in os.listdir(base_dir):
        if name.startswith("step_") and os.path.isfile(
                os.path.join(base_dir, name, "state")):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                pass
    return max(steps) if steps else None


def _step_or_latest(base_dir: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(base_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {base_dir}")
    return step


def load_checkpoint_config(base_dir: str, step: Optional[int] = None
                           ) -> Optional[dict]:
    """Read a checkpoint's ``config.json`` sidecar without restoring the
    state (the optimizer flags in it decide the state's layout); None if
    the checkpoint has no sidecar."""
    cfg_path = os.path.join(_ckpt_dir(base_dir, _step_or_latest(base_dir,
                                                                 step)),
                            "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            return json.load(f)
    return None


def restore_checkpoint(base_dir: str, target: TrainState,
                       step: Optional[int] = None
                       ) -> Tuple[TrainState, Optional[dict]]:
    """Restore into ``target`` (a state of the same structure, e.g. a
    fresh ``create_train_state``): its params, model state and optimizer
    tensors get the saved values in place.  Returns (state,
    config|None)."""
    step = _step_or_latest(base_dir, step)
    path = _ckpt_dir(base_dir, step)
    saved = torch.load(os.path.join(path, "state"), map_location="cpu",
                       weights_only=True)
    if set(saved["params"]) == set(target.params):
        # a target holding tp slices takes its slices of the global tree
        saved["params"], saved["opt_state"] = map_tp_state(
            target.params, saved["params"], saved["opt_state"],
            lambda _, rule, t: rule.local(t))
    _copy_by_name(path, "parameters", saved["params"], target.params)
    _copy_by_name(path, "model-state buffers", saved.get("model_state", {}),
                  target.model_state)
    load_opt_state(target.opt_state, saved["opt_state"])
    extra = {}
    for name in _extra_fields(target):
        if name not in saved:
            raise ValueError(f"checkpoint {path} holds no {name}")
        extra[name] = _copy_tree(f"{path}: {name}", saved[name],
                                 getattr(target, name))
    return (replace(target, step=int(saved["step"]), **extra),
            load_checkpoint_config(base_dir, step))


def _copy_tree(where: str, saved: Any, target: Any) -> Any:
    """``target`` with ``saved``'s values: tensors copied in place, numbers
    and None taken from ``saved``; raise where the structures differ."""
    def differ():
        return ValueError(f"{where}: the checkpoint holds {saved!r:.80}, "
                          f"which differs in structure from the target")

    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != target.shape:
            raise differ()
        with torch.no_grad():
            target.copy_(saved)
        return target
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            raise differ()
        for k, v in target.items():
            target[k] = _copy_tree(f"{where}[{k!r}]", saved[k], v)
        return target
    if isinstance(target, list):
        if not isinstance(saved, list) or len(saved) != len(target):
            raise differ()
        target[:] = [_copy_tree(f"{where}[{i}]", s, t)
                     for i, (s, t) in enumerate(zip(saved, target))]
        return target
    if (saved is None) != (target is None) or isinstance(
            saved, (torch.Tensor, dict, list)):
        raise differ()
    return saved


def _copy_by_name(path: str, what: str, saved: Dict[str, torch.Tensor],
                  target: Dict[str, torch.Tensor]) -> None:
    """Copy ``saved`` into ``target``'s tensors in place, by name; raise
    where the names or shapes differ."""
    if set(saved) != set(target):
        raise ValueError(f"checkpoint {path} holds {what} "
                         f"{sorted(set(saved) ^ set(target))} that the "
                         "target does not, or the reverse")
    with torch.no_grad():
        for name, t in target.items():
            if saved[name].shape != t.shape:
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(saved[name].shape)}, target "
                                 f"{tuple(t.shape)}")
            t.copy_(saved[name])
