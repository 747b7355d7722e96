"""The training step: smoothing noise -> attack -> forward -> update, and the
eval step (port of training/train.py).

One step follows the reference's per-iteration recipe
(examples/cifar10/train_and_attack.py:246-323;
odenet_mnist/train_validate.py:19-115):

  1. [smoothing] perturb each solver's (u, v) around (u0, v0), per batch;
  2. build the adversarial batch (``clean``, ``fgsm``, ``fgsm_random`` or
     ``at``, PGD), attacking through the noised solvers with the model in
     eval mode, on detached weights: the attack differentiates its loss with
     respect to the input only, so its backward runs B1's dgrad and B3's
     dx-only backward, and no wgrad;
  3. optional Gaussian data noise;
  4. forward in train mode, mean cross-entropy (+ ``ss_loss_reg`` times the
     ss-loss), gradients of the parameters (``torch.autograd.grad``);
  5. the optimizer update (``training/optimizers.py``), in place.

The base solvers are immutable, so the reference's denoise step is
implicit.  ``compute_dtype=torch.bfloat16`` is the port of JAX's
``_cast_model``: the input is cast to bf16 at the model's door (the attack
gradient is taken with respect to the f32 image through that cast), each
conv casts its f32 weight to bf16 at the call, and logits, ss-loss and loss
are f32, as are the master params and the optimizer state.  The step runs
under ``backend.full_f32()``, backward included, so f32 convs never take
TF32.  ``remat`` checkpoints each RK step of the ODE solves (the attack's
and the training pass's); ``unroll`` is accepted and ignored (the step
loop is a Python loop).

Randomness: ``step(state, x, y, generator)`` takes a CPU
``torch.Generator`` and draws three seeds from it, one each for the noise
(drawn on the CPU: the tableau is built on the host), the attack's uniform
start and the data noise (drawn on x's device), like the JAX step's key
split.  Under the switch and ensemble regimes it then draws two more, for
the attack's forwards and the training forward (JAX ``k_afwd``, ``k_fwd``),
whose regime draws come from CPU generators seeded with them; standalone
draws nothing there, so its stream is unchanged.  FGSM's one attack forward
draws from the attack-forward seed, PGD's iteration i from that seed plus
1 + i (JAX ``fold_in(k_afwd, i)``).

Spans (``backend.span``, recorded inside ``backend.record_spans()`` or a
``training/profiling.py`` trace): each step is one ``train.step`` unit
holding ``train.draws`` (the host's seed draws and solver noising), the
phases ``nodems.attack``, ``nodems.train_pass`` and ``nodems.update``, and
a ``train.backward`` around each ``torch.autograd.grad``.  The phases are
also ``torch.profiler.record_function`` ranges on every profiler trace
(``backend.phase``), which the benchmark reads for device time by phase
(``benchmark/harness/trace.py::by_range``, the ``attack_ms`` and
``update_ms`` readers of ``benchmark/metrics/``).

``make_eval_step`` returns the clean predictor the eval harness
(``training/evaluate.py``) runs under ``torch.inference_mode()``.

``integration_method="adjoint"`` differentiates the ODE blocks of the
attack's forwards and of the training pass by the continuous adjoint
(``ops/adjoint.py``).  ``step(..., dynamic_solvers=S)`` and ``predict(...,
dynamic_solvers=S)`` run with the solvers S in place of the ones the step
was built with (a u-sweep's, or trained ones), as JAX's traced argument
does; the port has no compilation to reuse, so this is exactly a step built
with S.  JAX compiler options have no counterpart.

Data parallelism (``parallel/mesh.py::make_parallel_train_step``):
``step(..., shard=S)`` (a ``parallel.mesh.StepShards``, whose ``data`` is
the data axis) takes this rank's slice of the global batch.  Every
draw sized by the batch (the attack's start, the data noise) is made at
the global shape and sliced to the rank, as JAX's sharded ``jax.random``
gives each shard its part; the per-step draws (noise, regime seeds) are
equal on every rank already.  Train-mode BatchNorm takes the global
batch's statistics (``models/nn.py::batch_norm``).  After
``torch.autograd.grad`` one flat f32 bucket of the gradients and the four
metrics is summed over the data group and divided by its size, so every
rank updates with the global batch's gradient; ``grad_norm`` is its norm
and ``skip_nonfinite`` decides on those global values, so every rank skips
together.  The attack's input gradient stays on its rank.
``DistributedDataParallel`` cannot serve here: its reducer hooks the
gradient-accumulator nodes, which ``torch.autograd.grad`` never runs.  A
one-rank axis runs none of this and is bit-equal to no shard.

The other axes come in the same ``shard``:
under an ``sp`` axis x is this rank's rows of the height too, the
batch-sized draws are made at the global shape and sliced by batch rows
and height rows, the forwards run under ``spatial_rows``, and the bucket
(gradients, metrics) and BatchNorm's statistics sum over data x sp, since
every rank's gradient is its rows' share.  Under a ``model`` axis the
params hold this rank's slices of the tp-sharded leaves; their gradients
are the slices' own and replicated params' gradients are whole on every
rank, so neither sums over ``model``: both go in the data (x sp) bucket.
``grad_norm`` (and ``skip_nonfinite``, which reads it) is the global
norm: the slices' squares are summed over the ``model`` axis
(``parallel.mesh.tp_global_norm``), so every rank skips together.  Under
a ``pp`` axis the pipelined stacks' gradients are summed over the axis
inside the pipeline (``parallel/pipeline.py``) and nothing changes here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from ..attacks import attacks
from ..backend import full_f32, phase, span, spanned
from ..ops.noise import noise_solver
from ..ops.regimes import SolverOptions
from ..parallel.mesh import (GlobalDraws, Shard, StepShards,
                             all_reduce_mean, data_shard, spatial_rows)
from .optimizers import Adam, Optimizer, RMSprop, SGD, global_norm

AnyOptimizer = Union[SGD, RMSprop, Adam, Optimizer]

__all__ = ["AttackConfig", "NoiseConfig", "LossConfig", "TrainState",
           "create_train_state", "make_train_step", "make_eval_step"]


@dataclass(frozen=True)
class AttackConfig:
    """Adversarial-training/eval attack settings
    (train_and_attack.py:130-158 flag set)."""

    mode: str = "clean"  # clean | fgsm | at (=PGD) | fgsm_random
    eps: float = 8 / 255
    alpha: float = 10 / 255  # fgsm_random step size
    pgd_lr: float = 2 / 255
    pgd_niter: int = 7
    pgd_random_start: bool = True
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
    ss_loss: bool = False
    ss_loss_reg: float = 0.1
    ss_loss_abs: bool = False
    data_noise_std: float = 0.0


@dataclass(frozen=True)
class TrainState:
    """``params`` are the model's own f32 parameters by ``named_parameters``
    name, ``model_state`` its buffers by ``named_buffers`` name (BN running
    statistics, SN vectors; empty for a stateless net); the step updates
    them and the optimizer state in place and returns the state with
    ``step`` advanced."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    model_state: Dict[str, torch.Tensor] = field(default_factory=dict)


def create_train_state(model, optimizer: AnyOptimizer,
                       state_dict: Optional[Dict[str, torch.Tensor]] = None,
                       opt_state: Optional[dict] = None,
                       step: int = 0) -> TrainState:
    """A state at ``step`` (default 0).  ``state_dict`` loads weights (and
    the model state's buffers) first, e.g.
    ``mnist_params_from_jax(np_params)`` to start from a JAX TrainState's
    params, or ``{**cifar_params_from_jax(p), **cifar_state_from_jax(s)}``
    for a CIFAR net with a model state; ``opt_state`` resumes the
    optimizer, e.g.
    ``rmsprop_state_from_jax(np_opt_state, step)`` (its tensors are copied
    to the parameters' devices), else it starts fresh."""
    if state_dict is not None:
        model.load_state_dict(state_dict)
    params = dict(model.named_parameters())
    fresh = optimizer.init(params)
    if opt_state is not None:
        load_opt_state(fresh, opt_state)
    return TrainState(step=step, params=params, opt_state=fresh,
                      model_state=dict(model.named_buffers()))


def load_opt_state(target: dict, saved: dict) -> None:
    """Copy an optimizer state ``saved`` into ``target``, a state of the
    same structure (numbers are replaced, tensors copied in place onto
    their devices); raise where the structures differ."""
    if set(saved) != set(target):
        raise ValueError(f"opt_state holds {sorted(saved)}, the "
                         f"optimizer's state {sorted(target)}")
    for key, bufs in target.items():
        if not isinstance(bufs, dict):
            target[key] = type(bufs)(saved[key])
            continue
        if set(saved[key]) != set(bufs):
            raise ValueError(f"opt_state[{key!r}] does not name the "
                             "model's parameters")
        with torch.no_grad():
            for name, buf in bufs.items():
                buf.copy_(saved[key][name])


def _noise_solvers(solvers, generator: torch.Generator,
                   noise_cfg: NoiseConfig):
    if noise_cfg.noise_type is None:
        return list(solvers)
    return [noise_solver(s, generator, std=noise_cfg.sigma,
                         bernoulli_p=noise_cfg.prob,
                         noise_type=noise_cfg.noise_type,
                         minimize_rk2_error=noise_cfg.minimize_rk2_error)
            for s in solvers]


def _regime_generator(seed):
    """A CPU generator for the regime draws of one forward, or None; a
    fleet's list of seeds (one a member) gives one generator a member."""
    if isinstance(seed, list):
        return [_regime_generator(s) for s in seed]
    return None if seed is None else torch.Generator().manual_seed(seed)


def _seed_plus(seed, k: int):
    """``seed + k`` for a seed, None or a fleet's list of seeds."""
    if isinstance(seed, list):
        return [_seed_plus(s, k) for s in seed]
    return None if seed is None else seed + k


def _run_attack(forward, attack_cfg: AttackConfig, x, y,
                generator: torch.Generator,
                fwd_seed: Optional[int] = None) -> torch.Tensor:
    """The adversarial batch (JAX ``train.py:154-173``); ``forward(xi,
    g)`` runs the model in eval mode on detached weights, with ``g`` the
    regime generator of that forward (from ``fwd_seed``, or None; a
    fleet's generators and seeds are lists, one a member)."""
    m, c = attack_cfg.mode, attack_cfg
    one = lambda xi: forward(xi, _regime_generator(fwd_seed))
    if m == "clean":
        return attacks.clean(x, y)[0]
    if m == "fgsm":
        return attacks.fgsm(one, x, y, c.eps, c.mean, c.std)[0]
    if m == "fgsm_random":
        return attacks.fgsm_random(one, generator, x, y, c.eps, c.alpha,
                                   c.mean, c.std)[0]
    if m == "at":
        # each iteration draws its own regime choice, as JAX's fwd_key does
        return attacks.pgd(
            lambda xi, i: forward(xi, _regime_generator(
                _seed_plus(fwd_seed, 1 + i))),
            generator, x, y, c.eps, c.pgd_lr, c.pgd_niter,
            c.pgd_random_start, c.mean, c.std, per_iteration=True)[0]
    raise ValueError("Attack type not understood.")


def _model_forward(model, solver_options, use_kernels: bool,
                   compute_dtype: Optional[torch.dtype], remat: bool,
                   integration_method: str = "backprop"):
    """``forward(x, solvers, train, params=None, ss=None, generator=None)
    -> (logits, ss, new_state)`` in f32: the input cast to
    ``compute_dtype`` at the model's door; ``ss`` a LossConfig whose
    ss-loss the forward adds (else 0); ``generator`` serves the regime
    draws; ``new_state`` the model state a train-mode forward returns (the
    current one in eval mode), which the forward does not commit."""

    def forward(x, solvers_t, train, params=None, ss=None, generator=None):
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        want_ss = ss is not None and ss.ss_loss
        logits, aux = model(
            x, solvers_t, solver_options, use_kernels=use_kernels,
            train=train, params=params, remat=remat, generator=generator,
            ss_loss=want_ss, ss_loss_abs=want_ss and ss.ss_loss_abs,
            integration_method=integration_method, return_aux=True)
        ss_val = (aux["ss_loss"].float() if want_ss
                  else torch.zeros((), device=logits.device))
        return logits.float(), ss_val, aux["model_state"]

    return forward


def _seeds(generator: torch.Generator, n: int):
    return torch.randint(0, 2 ** 62, (n,), generator=generator).tolist()


def _regime_seeds(generator: torch.Generator, solver_options: SolverOptions,
                  n: int):
    """``n`` seeds for the regime draws of switch and ensemble; standalone
    draws none (n Nones), so its generator stream is unchanged."""
    if solver_options.solver_mode == "standalone":
        return [None] * n
    return _seeds(generator, n)


def _batch_generator(device: torch.device, seed: int,
                     shard: Optional[StepShards]):
    """The generator of a batch-sized draw on ``device``; under a data
    shard it draws at the global batch's shape and keeps this rank's
    rows (and its rows of the height under an sp axis)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return g if shard is None else GlobalDraws(g, shard.data, shard.spatial)


def _randn_rows(x: torch.Tensor, seed: int, shard: Optional[StepShards]
                ) -> torch.Tensor:
    """N(0, 1) of x's shape on its device (the data noise), drawn at the
    global batch's shape under a data shard and sliced to this rank."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    fn = lambda shape: torch.randn(shape, generator=g, dtype=x.dtype,  # noqa: E731
                                   device=x.device)
    return (fn(x.shape) if shard is None
            else shard.data.draw(fn, x.shape, shard.spatial))


def _reduce_over_data(shard: Optional[Shard], scalars, grads):
    """The global batch's scalars and gradients: one all-reduce of a flat
    f32 bucket over the data (x sp) group, divided by its size
    (``scalars`` and ``grads`` unchanged without a shard or on a one-rank
    axis).  Returns the scalars then the list of gradients."""
    if shard is None or shard.group is None:
        return (*scalars, list(grads))
    grads = list(grads)
    out = all_reduce_mean(
        grads + [torch.stack([t.detach().float() for t in scalars])], shard)
    return (*out[-1].unbind(), out[:-1])


def make_train_step(model, optimizer: AnyOptimizer,
                    solvers: Sequence,
                    solver_options: SolverOptions = SolverOptions(),
                    attack_cfg: AttackConfig = AttackConfig(),
                    noise_cfg: NoiseConfig = NoiseConfig(),
                    loss_cfg: LossConfig = LossConfig(), *,
                    remat: bool = False, unroll: int = 1,
                    compute_dtype: Optional[torch.dtype] = None,
                    skip_nonfinite: bool = False,
                    use_kernels: bool = True,
                    integration_method: str = "backprop"):
    """Returns ``step(state, x, y, generator, dynamic_solvers=None,
    shard=None) -> (state, metrics)``; ``dynamic_solvers`` replaces
    ``solvers`` for that step, ``shard`` makes it one rank's part of a
    data-parallel step (module docstring).
    The attack reads the model state in eval mode; the training pass runs
    in train mode, and the model state it returns (BN running statistics,
    SN vectors) is copied into the model's buffers with the update, after
    the gradients, so remat's re-forwards and the attack never step it.

    x (B, H, W, C) f32 normalized images and y (B,) int64 labels on the
    model's device; metrics are 0-dim tensors there: loss, xentropy,
    ss_loss (0 unless ``loss_cfg.ss_loss``), accuracy, grad_norm (the
    global L2 norm of the gradients), and with ``skip_nonfinite`` also
    skipped_nonfinite (1 when a non-finite loss or gradient left the params
    and optimizer state unchanged; the check reads one value back to the
    host).  ``use_kernels=False`` runs the model's plain path (``F.conv2d``
    and autograd everywhere), which the kernel path is checked against on
    the card."""
    del unroll
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype} not supported")
    forward = _model_forward(model, solver_options, use_kernels,
                             compute_dtype, remat, integration_method)

    @spanned("train.step", unit=True)
    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
             generator: torch.Generator, dynamic_solvers=None,
             shard: Optional[StepShards] = None):
        reduce = None if shard is None else shard.reduce
        with span("train.draws"):
            s_noise, s_attack, s_data = _seeds(generator, 3)
            s_afwd, s_fwd = _regime_seeds(generator, solver_options, 2)
            base = (solvers if dynamic_solvers is None
                    else list(dynamic_solvers))
            solvers_t = _noise_solvers(
                base, torch.Generator().manual_seed(s_noise), noise_cfg)
        with full_f32(), data_shard(reduce), spatial_rows(
                None if shard is None else shard.spatial):
            with phase("nodems.attack"):
                frozen = model.detached_params()
                x_adv = _run_attack(
                    lambda xi, g: forward(xi, solvers_t, False, frozen,
                                          generator=g)[0],
                    attack_cfg, x, y,
                    _batch_generator(x.device, s_attack, shard), s_afwd)
            if loss_cfg.data_noise_std > 1e-12:
                x_adv = x_adv + loss_cfg.data_noise_std * _randn_rows(
                    x_adv, s_data, shard)
            with phase("nodems.train_pass"), torch.enable_grad():
                logits, ss, new_state = forward(
                    x_adv, solvers_t, True, ss=loss_cfg,
                    generator=_regime_generator(s_fwd))
                xent = attacks.cross_entropy(logits, y)
                loss = xent
                if loss_cfg.ss_loss:
                    loss = loss + loss_cfg.ss_loss_reg * ss
                with span("train.backward"):
                    grads = torch.autograd.grad(
                        loss, list(state.params.values()))
            acc = (logits.argmax(-1) == y).float().mean()
            loss, xent, ss, acc, grads = _reduce_over_data(
                reduce, [loss, xent, ss, acc], grads)
            gnorm = global_norm(grads, like=list(state.params.values()))
            metrics = {"loss": loss.detach(), "xentropy": xent.detach(),
                       "ss_loss": ss.detach(), "accuracy": acc,
                       "grad_norm": gnorm}
            ok = True
            if skip_nonfinite:
                # a skipped step leaves params, optimizer and model state;
                # the non-finite backoff records it (JAX train.py:255-297)
                ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
                metrics["skipped_nonfinite"] = torch.tensor(
                    float(not ok), device=x.device)
            with phase("nodems.update"):
                if ok:
                    optimizer.update(state.params, grads, state.opt_state)
                    # a skipped step keeps its BN/SN state too (JAX
                    # train.py:307-316)
                    model.commit_state(new_state)
                else:
                    optimizer.update(state.params, grads, state.opt_state,
                                     skip=True)
        return TrainState(state.step + 1, state.params, state.opt_state,
                          state.model_state), metrics

    return step


def make_eval_step(model, solvers: Sequence,
                   solver_options: SolverOptions = SolverOptions(), *,
                   remat: bool = False, unroll: int = 1,
                   compute_dtype: Optional[torch.dtype] = None,
                   use_kernels: bool = True):
    """Returns ``predict(x, generator=None, dynamic_solvers=None) ->
    logits`` (``dynamic_solvers`` replacing ``solvers``): the eval-mode
    forward of x (B, H, W, C) on the model's device, f32 logits, under
    ``torch.inference_mode()`` (JAX ``train.py:336-360``); ``generator``, a
    CPU generator, serves the switch and ensemble draws.  ``remat`` and
    ``unroll`` shape only a differentiated graph, so under inference mode
    they change nothing; they are accepted for the JAX signature."""
    del remat, unroll
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype} not supported")
    forward = _model_forward(model, solver_options, use_kernels,
                             compute_dtype, False)

    def predict(x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dynamic_solvers=None) -> torch.Tensor:
        base = solvers if dynamic_solvers is None else list(dynamic_solvers)
        with torch.inference_mode():
            return forward(x, base, False, generator=generator)[0]

    return predict
