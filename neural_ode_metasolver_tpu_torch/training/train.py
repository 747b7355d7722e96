"""The training step: smoothing noise -> attack -> forward -> update (port of
training/train.py).

One step follows the reference's per-iteration recipe
(examples/cifar10/train_and_attack.py:246-323):

  1. [smoothing] perturb each solver's (u, v) around (u0, v0), per batch;
  2. build the adversarial batch (``clean`` or ``fgsm_random``), attacking
     through the noised solvers with the model in eval mode, on detached
     weights: the attack differentiates its loss with respect to the
     perturbation only, so its backward runs B1's dgrad and no wgrad;
  3. optional Gaussian data noise;
  4. forward in train mode, mean cross-entropy, gradients of the
     parameters (``torch.autograd.grad``);
  5. the SGD update, in place.

The base solvers are immutable, so the reference's denoise step is
implicit.  ``compute_dtype=torch.bfloat16`` is the port of JAX's
``_cast_model``: the input is cast to bf16 at the model's door (the attack
gradient is taken with respect to the f32 image through that cast), each
conv casts its f32 weight to bf16 at the call, and logits and loss are f32,
as are the master params and the optimizer state.  The step runs under
``backend.full_f32()``, backward included, so f32 convs never take TF32.

Randomness: ``step(state, x, y, generator)`` takes a CPU
``torch.Generator`` and draws three seeds from it, one each for the noise
(drawn on the CPU: the tableau is built on the host), the attack's uniform
start and the data noise (drawn on x's device), like the JAX step's key
split.

The phases run inside ``torch.profiler.record_function`` ranges
``nodems.attack``, ``nodems.train_pass`` and ``nodems.update``, which a
trace reads for device time by phase (``scripts/profile_torch_training.py``).

Not ported yet: other attack modes (ROADMAP A9), the ss-loss (A10/A12),
``make_eval_step`` (A13), ``remat``/``unroll``, the adjoint and
``dynamic_solvers`` (A13/A18).  JAX compiler options have no counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from ..attacks import attacks
from ..backend import full_f32
from ..ops.noise import noise_solver
from ..ops.regimes import SolverOptions
from .optimizers import SGD

__all__ = ["AttackConfig", "NoiseConfig", "LossConfig", "TrainState",
           "create_train_state", "make_train_step"]


@dataclass(frozen=True)
class AttackConfig:
    """Adversarial-training attack settings (train_and_attack.py:130-158)."""

    mode: str = "clean"  # clean | fgsm_random (fgsm | at: ROADMAP A9)
    eps: float = 8 / 255
    alpha: float = 10 / 255  # fgsm_random step size
    mean: Optional[Tuple[float, ...]] = None
    std: Optional[Tuple[float, ...]] = None


@dataclass(frozen=True)
class NoiseConfig:
    """Solver smoothing (train_and_attack.py:74-79 flags)."""

    noise_type: Optional[str] = None  # None | 'cauchy' | 'normal'
    sigma: float = 0.001
    prob: float = 0.0
    minimize_rk2_error: bool = False


@dataclass(frozen=True)
class LossConfig:
    ss_loss: bool = False  # ROADMAP A10/A12
    data_noise_std: float = 0.0


@dataclass(frozen=True)
class TrainState:
    """``params`` are the model's own f32 parameters by ``named_parameters``
    name; the step updates them and the optimizer state in place and
    returns the state with ``step`` advanced."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any


def create_train_state(model, optimizer: SGD,
                       state_dict: Optional[Dict[str, torch.Tensor]] = None
                       ) -> TrainState:
    """A fresh state at step 0.  ``state_dict`` loads weights first, e.g.
    ``cifar_params_from_jax(np_params)`` to start from a JAX TrainState's
    params (the optimizer state is always fresh)."""
    if state_dict is not None:
        model.load_state_dict(state_dict)
    params = dict(model.named_parameters())
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def _noise_solvers(solvers, generator: torch.Generator,
                   noise_cfg: NoiseConfig):
    if noise_cfg.noise_type is None:
        return list(solvers)
    return [noise_solver(s, generator, std=noise_cfg.sigma,
                         bernoulli_p=noise_cfg.prob,
                         noise_type=noise_cfg.noise_type,
                         minimize_rk2_error=noise_cfg.minimize_rk2_error)
            for s in solvers]


def _run_attack(forward, attack_cfg: AttackConfig, x, y,
                generator: torch.Generator) -> torch.Tensor:
    m = attack_cfg.mode
    if m == "clean":
        return attacks.clean(x, y)[0]
    if m == "fgsm_random":
        return attacks.fgsm_random(forward, generator, x, y, attack_cfg.eps,
                                   attack_cfg.alpha, attack_cfg.mean,
                                   attack_cfg.std)[0]
    if m in ("fgsm", "at"):
        raise NotImplementedError(
            f"attack mode {m!r} is not ported yet (ROADMAP A9)")
    raise ValueError("Attack type not understood.")


def _seeds(generator: torch.Generator, n: int):
    return torch.randint(0, 2 ** 62, (n,), generator=generator).tolist()


def make_train_step(model, optimizer: SGD, solvers: Sequence,
                    solver_options: SolverOptions = SolverOptions(),
                    attack_cfg: AttackConfig = AttackConfig(),
                    noise_cfg: NoiseConfig = NoiseConfig(),
                    loss_cfg: LossConfig = LossConfig(), *,
                    compute_dtype: Optional[torch.dtype] = None,
                    skip_nonfinite: bool = False,
                    use_kernels: bool = True):
    """Returns ``step(state, x, y, generator) -> (state, metrics)``.

    x (B, H, W, C) f32 normalized images and y (B,) int64 labels on the
    model's device; metrics are 0-dim tensors there: loss, xentropy,
    accuracy, grad_norm (the global L2 norm of the gradients), and with
    ``skip_nonfinite`` also skipped_nonfinite (1 when a non-finite loss or
    gradient left the params and optimizer state unchanged; the check reads
    one value back to the host).  ``use_kernels=False`` runs the model's
    plain path (``F.conv2d`` everywhere), which the kernel path is checked
    against on the card."""
    if loss_cfg.ss_loss:
        raise NotImplementedError("ss_loss is not ported yet (ROADMAP A10/A12)")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype} not supported")

    def forward(x, solvers_t, train, params=None):
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        logits = model(x, solvers_t, solver_options, use_kernels=use_kernels,
                       train=train, params=params)
        return logits.float()

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
             generator: torch.Generator):
        s_noise, s_attack, s_data = _seeds(generator, 3)
        solvers_t = _noise_solvers(
            solvers, torch.Generator().manual_seed(s_noise), noise_cfg)
        with full_f32():
            with record_function("nodems.attack"):
                frozen = model.detached_params()
                x_adv = _run_attack(
                    lambda xi: forward(xi, solvers_t, False, frozen),
                    attack_cfg, x, y,
                    torch.Generator(device=x.device).manual_seed(s_attack))
            if loss_cfg.data_noise_std > 1e-12:
                g = torch.Generator(device=x.device).manual_seed(s_data)
                x_adv = x_adv + loss_cfg.data_noise_std * torch.randn(
                    x_adv.shape, generator=g, dtype=x_adv.dtype,
                    device=x_adv.device)
            with record_function("nodems.train_pass"), torch.enable_grad():
                logits = forward(x_adv, solvers_t, True)
                xent = attacks.cross_entropy(logits, y)
                loss = xent
                grads = torch.autograd.grad(loss, list(state.params.values()))
            gnorm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            metrics = {"loss": loss.detach(), "xentropy": xent.detach(),
                       "accuracy": (logits.argmax(-1) == y).float().mean(),
                       "grad_norm": gnorm}
            ok = True
            if skip_nonfinite:
                ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
                metrics["skipped_nonfinite"] = torch.tensor(
                    float(not ok), device=x.device)
            if ok:
                with record_function("nodems.update"):
                    optimizer.update(state.params, grads, state.opt_state)
        return TrainState(state.step + 1, state.params, state.opt_state), \
            metrics

    return step
