"""Evaluation harness: clean, adversarial and ensemble accuracies,
``sn_test`` and the Evaluate-notebook regime grid (port of
training/evaluate.py).

Parity targets: ``accuracy`` odenet_mnist/metrics.py:9-24, normalized by
the number of samples, tail batch included (PARITY.md quirk 12);
``adversarial_accuracy`` train_and_attack.py:212-243: attack every batch
with the model in eval mode on detached weights, then a no-grad forward;
``accuracy_ensemble`` and ``adversarial_accuracy_ensemble`` model
ensembling by the mean of the members' softmax, attacked jointly by
``fgsm2ensemble`` (cifar10 Evaluate notebook cell 25; fgsm.py:121-155);
``sn_test`` the step-count sweep (odenet_mnist/metrics.py:27-41).

Each batch's argmax count stays on the device; the counts are read back
once, after the last batch, so batches are not held up by a readback each.
``data`` yields (x, y) pairs, numpy arrays or tensors, x (B, H, W, C)
normalized images and y (B,) integer labels.

Randomness: a CPU ``torch.Generator`` passed to an entry point gives each
batch its seeds: ``accuracy`` one, for the regime draws of the forward;
``adversarial_accuracy`` one for the attack's random start (on the model's
device) and, under switch and ensemble, one for the forwards' regime draws
(JAX ``k_attack``, ``k_fwd``); the ensemble entry points one per member.  A
forward's regime draws come from a CPU generator seeded with its seed, so
an attacked batch is evaluated under the draw its FGSM attacked, as in JAX.

A member of an ensemble is ``(model, solvers, options)``: the port's models
carry their own parameters and model state.  Every forward here runs in
eval mode and reads the model's state (BN running statistics, SN vectors)
from its buffers; nothing here writes it.

Parallel axes: under a ``model`` axis the model's parameters hold this
rank's tp slices and every forward here runs the tp forward; a model with
a ``pipeline`` runs its stacks through GPipe (every rank of the axis must
evaluate alike); ``spatial=`` (an sp axis, ``parallel/mesh.py``) makes
``accuracy`` and ``adversarial_accuracy`` evaluate each batch on this
rank's rows of the height, the attack's random start drawn at the whole
image's shape and sliced, so every rank counts the same predictions.

``mesh=`` runs the ensemble-by-noising shape (one model, one options, one
solver a member differing only in u/v) on the member axis instead of the
member loop: the model's params are repeated along a leading member axis
and the members run through the fleet's member path
(``training/fleet.py``), so B1 and B3 launch once for all of a rank's
members, each with its own stacked tableau and its own stage times.  With
an ``ensemble`` axis of k ranks each rank runs its n/k contiguous members
and the partial sums of their softmax are summed over the axis; the
attacked entry points differentiate through that sum (``parallel/
mesh.py``: the sum's backward passes the replicated gradient on, the
input's sums the ranks' shares), so every rank attacks with the whole
ensemble's input gradient.  Member m's regime draws come from the seed the
loop path gives it, whichever rank it lands on.  A one-rank axis runs no
collective.
"""
from __future__ import annotations

from typing import (Callable, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from ..attacks import fgsm2ensemble, fgsm_mean_prob_attack
from ..backend import full_f32
from ..ops.noise import solver_ensemble_by_noising
from ..ops.regimes import SolverOptions
from ..ops.solver import ParametricSolver
from ..parallel.ensemble import member_rows, stack_solver_params
from ..parallel.mesh import (GlobalDraws, Shard, all_sum_replicated,
                             replicate_grad, spatial_rows)
from .fleet import _fleet_forward, _member_solvers, tile_fleet
from .train import (AttackConfig, NoiseConfig, _model_forward,
                    _regime_generator, _regime_seeds, _run_attack, _seeds,
                    make_eval_step)

__all__ = [
    "accuracy",
    "make_adversarial_predict",
    "adversarial_accuracy",
    "make_ensemble_probs",
    "accuracy_ensemble",
    "make_ensemble_attacked_probs",
    "adversarial_accuracy_ensemble",
    "sn_test",
    "RegimeSpec",
    "notebook_regime_grid",
]

Batches = Iterable[Tuple[object, object]]
Member = Tuple[object, Sequence[ParametricSolver], SolverOptions]


def _accumulate_accuracy(device: torch.device, data: Batches,
                         batch_scores) -> float:
    """The counting loop of every accuracy entry point: ``batch_scores(x,
    y)`` returns a batch's logits or probabilities; the correct counts add
    up on the device and are read once."""
    counts = []
    total = 0
    for x, y in data:
        x = torch.as_tensor(x, device=device)
        y = torch.as_tensor(y, device=device).long()
        counts.append((batch_scores(x, y).argmax(-1) == y).sum())
        total += int(y.shape[0])
    correct = int(torch.stack(counts).sum()) if counts else 0
    return correct / max(total, 1)


def _rows(x: torch.Tensor, spatial: Optional[Shard]) -> torch.Tensor:
    """This rank's rows of x's height under an sp axis, else x."""
    return x if spatial is None else x[:, spatial.rows(x.shape[1])]


def accuracy(model, solvers: Sequence, solver_options: SolverOptions,
             data: Batches, predict=None,
             generator: Optional[torch.Generator] = None, *,
             spatial: Optional[Shard] = None) -> float:
    """Clean accuracy of ``model`` over ``data``; ``predict`` (from
    ``make_eval_step``) may be passed in, else one is built.  Under switch
    and ensemble, which need ``generator``, each batch's forward draws its
    regime choices from a seed of its own; standalone draws none.
    ``spatial``: the sp axis each batch's rows are split over."""
    if predict is None:
        predict = make_eval_step(model, solvers, solver_options)

    def batch_scores(x, y):
        with spatial_rows(spatial):
            if generator is None:
                return predict(_rows(x, spatial))
            (seed,) = _regime_seeds(generator, solver_options, 1)
            return predict(_rows(x, spatial), _regime_generator(seed))

    return _accumulate_accuracy(model.device, data, batch_scores)


def make_adversarial_predict(model, solvers: Sequence,
                             solver_options: SolverOptions,
                             attack_cfg: AttackConfig, *,
                             remat: bool = False, unroll: int = 1,
                             compute_dtype: Optional[torch.dtype] = None,
                             use_kernels: bool = True):
    """``attacked_logits(x, y, generator, fwd_seed=None) -> logits``: the
    attack of ``attack_cfg`` (the train step's dispatch) through the model
    in eval mode on detached weights, with grad mode on for its input
    gradients, then the eval-mode forward of the attacked batch under
    ``torch.inference_mode()``.  ``generator`` seeds the attack's random
    start on x's device; ``fwd_seed`` the regime draws of the attack's
    forwards and of the final forward, which draws what FGSM's forward
    drew.  ``remat`` checkpoints the attack's RK steps; ``unroll`` is
    accepted and ignored."""
    del unroll
    forward = _model_forward(model, solver_options, use_kernels,
                             compute_dtype, remat)

    def attacked_logits(x: torch.Tensor, y: torch.Tensor,
                        generator: Optional[torch.Generator],
                        fwd_seed: Optional[int] = None) -> torch.Tensor:
        frozen = model.detached_params()
        with full_f32(), torch.enable_grad():
            xa = _run_attack(lambda xi, g: forward(xi, solvers, False,
                                                   frozen, generator=g)[0],
                             attack_cfg, x, y, generator, fwd_seed)
        with torch.inference_mode():
            return forward(xa, solvers, False,
                           generator=_regime_generator(fwd_seed))[0]

    return attacked_logits


def adversarial_accuracy(model, solvers: Sequence,
                         solver_options: SolverOptions, data: Batches,
                         attack_cfg: AttackConfig,
                         generator: torch.Generator, predict=None, *,
                         remat: bool = False, unroll: int = 1,
                         spatial: Optional[Shard] = None) -> float:
    """Accuracy on attacked batches (train_and_attack.py:212-243).  Each
    batch draws from ``generator`` (a CPU generator the caller seeds) a
    seed for the attack's generator on the model's device and, under
    switch and ensemble, a seed for the regime draws.  ``predict`` (from
    ``make_adversarial_predict``) may be passed in, else one is built with
    ``remat`` and ``unroll``.  ``spatial``: the sp axis each batch's rows
    are split over (the random start drawn whole and sliced)."""
    if predict is None:
        predict = make_adversarial_predict(model, solvers, solver_options,
                                           attack_cfg, remat=remat,
                                           unroll=unroll)
    dev = model.device

    def batch_scores(x, y):
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
        (fwd_seed,) = _regime_seeds(generator, solver_options, 1)
        g = torch.Generator(device=dev).manual_seed(seed)
        if spatial is not None:
            g = GlobalDraws(g, Shard("batch", 1, 0), spatial)
        with spatial_rows(spatial):
            return predict(_rows(x, spatial), y, g, fwd_seed)

    return _accumulate_accuracy(dev, data, batch_scores)


# ------------------------------------------------------- model ensembling


def _member_forwards(members: Sequence[Member], use_kernels: bool,
                     compute_dtype: Optional[torch.dtype], remat: bool
                     ) -> List[Callable]:
    """``fwd(x, seed, params=None) -> f32 logits`` of each member in eval
    mode, its regime draws from a CPU generator seeded with ``seed``."""
    out = []
    for model, solvers, options in members:
        forward = _model_forward(model, options, use_kernels, compute_dtype,
                                 remat)
        out.append(lambda x, seed, params=None, _f=forward, _s=solvers: _f(
            x, _s, False, params, generator=_regime_generator(seed))[0])
    return out


def _mean_probs(fwds, x, seeds) -> torch.Tensor:
    """The mean over the members of their softmax at ``x``."""
    probs = None
    for fwd, seed in zip(fwds, seeds):
        p = torch.softmax(fwd(x, seed), dim=-1)
        probs = p if probs is None else probs + p
    return probs / len(fwds)


def _homogeneous_solver_members(members: Sequence[Member]):
    """The ensemble-by-noising shape: every member shares the model and
    the options and carries ONE solver differing only in (u, v).  Returns
    (model, options, the first solver, u, v stacked (n,)); raises the one
    ValueError both mesh entry points share otherwise."""
    err = ValueError(
        "mesh-sharded ensemble eval needs homogeneous members "
        "(same params/state/options, one solver varying only in "
        "u/v — what solver_ensemble_by_noising produces)"
    )
    m0, sol0, o0 = members[0]
    if len(sol0) != 1:
        raise err
    for m, sol, o in members[1:]:
        if m is not m0 or o != o0 or len(sol) != 1:
            raise err
    try:
        ref, u, v = stack_solver_params([m[1][0] for m in members])
    except ValueError:
        raise err from None
    return m0, o0, ref, u, v


def _vmapped_member_probs(members: Sequence[Member], mesh, member_axis: str,
                          use_kernels: bool,
                          compute_dtype: Optional[torch.dtype], remat: bool):
    """``probs(x, seeds) -> (B, classes)``: the mean over all members of
    their softmax, this rank's members run at once on the member axis
    (the model's params and state repeated along it, x tiled, the solvers
    stacked) and their partial sum reduced over ``member_axis``; ``seeds``
    one per member (all members', or None under standalone).  x may
    require grad (the attack's forward)."""
    model, options, ref, u, v = _homogeneous_solver_members(members)
    n = len(members)
    rows, shard = member_rows(n, mesh, member_axis)
    k = rows.stop - rows.start
    u, v = u[rows], None if v is None else v[rows]
    forward = _fleet_forward(model, options, use_kernels, compute_dtype,
                             remat, "backprop")

    def probs(x: torch.Tensor, seeds=None) -> torch.Tensor:
        if seeds is None or seeds[0] is None:
            # as the loop path: a regime that draws must not run unseeded
            if options.solver_mode in ("switch", "ensemble"):
                raise ValueError(
                    f"{options.solver_mode} mode needs a PRNG key")
            gens = None
        else:
            gens = _regime_generator(list(seeds[rows]))
        params = {name: tile_fleet(p.detach(), k)
                  for name, p in model.named_parameters()}
        state = {name: tile_fleet(b, k) for name, b in model.named_buffers()}
        solvers_t = _member_solvers([ref.replace(u=u, v=v)], k, None,
                                    NoiseConfig(), x.device)
        if shard is not None:
            x = replicate_grad(x, shard)
        xs = x.unsqueeze(0).expand((k,) + tuple(x.shape)).contiguous()
        logits = forward(xs, solvers_t, False, params, state,
                         generators=gens)[0]
        part = torch.softmax(logits, dim=-1).sum(0)
        if shard is not None:
            part = all_sum_replicated(part, shard)
        return part / n

    return probs


def make_ensemble_probs(members: Sequence[Member], *, mesh=None,
                        member_axis: str = "ensemble",
                        compute_dtype: Optional[torch.dtype] = None,
                        use_kernels: bool = True):
    """``probs_fn(x, seeds=None) -> (B, classes)``: the mean of the
    members' softmax in eval mode under ``torch.inference_mode()``;
    ``seeds`` (one per member, or None) serve their regime draws.
    ``mesh`` runs the members on the member axis, sharded over
    ``member_axis`` (module docstring)."""
    if mesh is not None:
        vprobs = _vmapped_member_probs(members, mesh, member_axis,
                                       use_kernels, compute_dtype, False)

        def mesh_probs(x: torch.Tensor, seeds=None) -> torch.Tensor:
            with torch.inference_mode():
                return vprobs(x, seeds)

        return mesh_probs
    fwds = _member_forwards(members, use_kernels, compute_dtype, False)

    def probs_fn(x: torch.Tensor, seeds=None) -> torch.Tensor:
        with torch.inference_mode():
            return _mean_probs(fwds, x, seeds or [None] * len(fwds))

    return probs_fn


def accuracy_ensemble(members: Sequence[Member], data: Batches,
                      generator: Optional[torch.Generator] = None, *,
                      mesh=None, member_axis: str = "ensemble",
                      predict=None,
                      compute_dtype: Optional[torch.dtype] = None,
                      use_kernels: bool = True) -> float:
    """Accuracy of the softmax-averaged ensemble (Evaluate notebook cell
    25); with ``generator`` each batch draws one seed per member.
    ``predict`` (from ``make_ensemble_probs``) may be passed in; ``mesh``
    runs the members on the member axis, sharded over ``member_axis``
    (homogeneous members only, else ValueError)."""
    probs_fn = predict if predict is not None else make_ensemble_probs(
        members, mesh=mesh, member_axis=member_axis,
        compute_dtype=compute_dtype, use_kernels=use_kernels)
    n = len(members)
    return _accumulate_accuracy(
        members[0][0].device, data,
        lambda x, y: probs_fn(x, None if generator is None
                              else _seeds(generator, n)))


def make_ensemble_attacked_probs(members: Sequence[Member],
                                 attack_cfg: AttackConfig, *, mesh=None,
                                 member_axis: str = "ensemble",
                                 remat: bool = False,
                                 compute_dtype: Optional[torch.dtype] = None,
                                 use_kernels: bool = True):
    """``attacked_probs(x, y, seeds=None)``: the joint ``fgsm2ensemble``
    (eps, mean and std of ``attack_cfg``) through every member in eval
    mode on detached weights, then the mean of the members' softmax at the
    attacked batch under ``torch.inference_mode()``.  A member's attack
    forward and final forward draw from the same seed.  ``remat``
    checkpoints the attack's RK steps.  ``mesh``: the members on the
    member axis, sharded over ``member_axis``; the attack differentiates
    the same mean probabilities through the axis's sum."""
    if mesh is not None:
        atk = _vmapped_member_probs(members, mesh, member_axis, use_kernels,
                                    compute_dtype, remat)
        vprobs = _vmapped_member_probs(members, mesh, member_axis,
                                       use_kernels, compute_dtype, False)

        def mesh_attacked(x: torch.Tensor, y: torch.Tensor,
                          seeds=None) -> torch.Tensor:
            with full_f32(), torch.enable_grad():
                xa, _ = fgsm_mean_prob_attack(
                    lambda xn: atk(xn, seeds), x, y, attack_cfg.eps,
                    attack_cfg.mean, attack_cfg.std)
            with torch.inference_mode():
                return vprobs(xa, seeds)

        return mesh_attacked
    fwds = _member_forwards(members, use_kernels, compute_dtype, False)
    atk = (_member_forwards(members, use_kernels, compute_dtype, True)
           if remat else fwds)

    def attacked_probs(x: torch.Tensor, y: torch.Tensor,
                       seeds=None) -> torch.Tensor:
        seeds = seeds or [None] * len(fwds)
        trees = [m[0].detached_params() for m in members]
        with full_f32(), torch.enable_grad():
            xa, _ = fgsm2ensemble(
                [lambda xi, i=i: atk[i](xi, seeds[i], trees[i])
                 for i in range(len(atk))],
                x, y, attack_cfg.eps, attack_cfg.mean, attack_cfg.std)
        with torch.inference_mode():
            return _mean_probs(fwds, xa, seeds)

    return attacked_probs


def adversarial_accuracy_ensemble(members: Sequence[Member], data: Batches,
                                  attack_cfg: AttackConfig,
                                  generator: torch.Generator, *, mesh=None,
                                  member_axis: str = "ensemble",
                                  predict=None, remat: bool = False,
                                  compute_dtype: Optional[torch.dtype] = None,
                                  use_kernels: bool = True) -> float:
    """Ensemble accuracy on batches attacked by ``fgsm2ensemble`` (notebook
    cell 25; fgsm.py:109-155); each batch draws one seed per member from
    ``generator``.  ``predict`` (from ``make_ensemble_attacked_probs``) may
    be passed in; ``mesh`` as in ``accuracy_ensemble``."""
    attacked = predict if predict is not None else \
        make_ensemble_attacked_probs(members, attack_cfg, mesh=mesh,
                                     member_axis=member_axis, remat=remat,
                                     compute_dtype=compute_dtype,
                                     use_kernels=use_kernels)
    return _accumulate_accuracy(
        members[0][0].device, data,
        lambda x, y: attacked(x, y, _seeds(generator, len(members))))


# ------------------------------------------------------------ step sweep


def _regrid(solver: ParametricSolver, n: int) -> ParametricSolver:
    """``solver`` on an n-step grid: every other grid source cleared, or a
    leftover ``custom_grid`` would win (``ParametricSolver.time_grid``)."""
    return solver.replace(n_steps=int(n), step_size=None, custom_grid=None)


def sn_test(model, solver: ParametricSolver, solver_options: SolverOptions,
            data_factory: Callable[[], Batches], nsteps_grid: Sequence[int],
            generator: Optional[torch.Generator] = None, *,
            compute_dtype: Optional[torch.dtype] = None,
            use_kernels: bool = True) -> List[float]:
    """Clean accuracy of ``model`` with ``solver`` regridded to each step
    count of ``nsteps_grid`` (odenet_mnist/metrics.py:27-41);
    ``data_factory()`` gives a fresh iterable per count.  Each count starts
    from ``generator``'s state at the call, as JAX reuses its key."""
    state = None if generator is None else generator.get_state()
    accs = []
    for n in nsteps_grid:
        s = [_regrid(solver, n)]
        g = None
        if state is not None:
            g = torch.Generator()
            g.set_state(state)
        predict = make_eval_step(model, s, solver_options,
                                 compute_dtype=compute_dtype,
                                 use_kernels=use_kernels)
        accs.append(accuracy(model, s, solver_options, data_factory(),
                             predict=predict, generator=g))
    return accs


# ----------------------------------------------------------- regime grid


class RegimeSpec(NamedTuple):
    """One row of the Evaluate-notebook regime grid (cells 13-28).

    ``solvers``/``options`` drive ``accuracy``/``adversarial_accuracy``;
    for the model-ensembling row they are the noised member solvers, each
    paired with the model as ``(model, [s], SolverOptions())`` for
    ``accuracy_ensemble``/``adversarial_accuracy_ensemble``
    (``is_model_ensemble``).  ``needs_key``: the regime draws on every
    forward, in clean evaluation too."""

    name: str
    solvers: Sequence[ParametricSolver]
    options: SolverOptions
    is_model_ensemble: bool = False
    needs_key: bool = False


def notebook_regime_grid(base_solver: ParametricSolver,
                         generator: torch.Generator, *, u_alt: float = 1.0,
                         switch_probs: Sequence[float] = (0.6, 0.4),
                         ensemble_weights: Sequence[float] = (0.6, 0.4),
                         ensemble_size: int = 2, noise_std: float = 0.2,
                         noise_type: str = "normal") -> List[RegimeSpec]:
    """The reference's four-regime evaluation table as data (cifar10
    ``Evaluate the model.ipynb`` cells 13-28; BASELINE.md rows 21-24):

      1. standalone: ``base_solver`` alone;
      2. switch[p...]: {base, u=u_alt} under ``switch_probs``;
      3. solver_ens[w...]: the same pair, ensemble_prob 1, the weights;
      4. model_ensembling: ``ensemble_size`` solvers, the original first
         and copies noised by ``noise_type`` with std ``noise_std`` (drawn
         from ``generator``), evaluated by the mean softmax with the joint
         ensemble FGSM (notebook cell 25)."""
    alt = base_solver.replace(
        u=torch.tensor(u_alt, dtype=base_solver.u.dtype), u0=u_alt)
    fmt = lambda xs: ",".join(f"{x:g}" for x in xs)
    noised = solver_ensemble_by_noising(
        base_solver, generator, ensemble_size=ensemble_size, std=noise_std,
        noise_type=noise_type)
    return [
        RegimeSpec("standalone", [base_solver], SolverOptions()),
        RegimeSpec(f"switch[{fmt(switch_probs)}]", [base_solver, alt],
                   SolverOptions(solver_mode="switch",
                                 switch_probs=list(switch_probs)),
                   needs_key=True),
        RegimeSpec(f"solver_ens[{fmt(ensemble_weights)}]", [base_solver, alt],
                   SolverOptions(solver_mode="ensemble", ensemble_prob=1.0,
                                 ensemble_weights=list(ensemble_weights)),
                   needs_key=True),
        RegimeSpec("model_ensembling", noised, SolverOptions(),
                   is_model_ensemble=True),
    ]
