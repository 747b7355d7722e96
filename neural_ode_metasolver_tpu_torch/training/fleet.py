"""Fleet training: one step advances S independent runs at once (port of
training/fleet.py).

A fleet is S runs of one model, its members, each with its own seed and,
in a u-sweep, its own solver coefficients.  Their params, optimizer state
and model state are stacked along a leading member axis, and one step
runs all of them: every layer takes its members' path (``models/nn.py``),
so each kernel (B1 forward, its dgrad and split-K wgrad, B3 and its
backward) is one launch for all S members (``ops/conv3x3.py``,
``ops/group_norm.py``), and the host issues about one run's work per step
while the card does S runs'.  That is the point on the H100 as on the TPU:
a digits-size MNIST step is host-bound (PERF.md section 5).

Per-member semantics are ``make_train_step``'s:
  * member m draws its step seeds (noise, attack start, data noise, then
    under switch and ensemble the attack's and the training forward's
    regime seeds) from its own CPU generator, in the single step's order
    (``fleet_generators(seeds)[m]`` is the generator a single run seeded
    with ``seeds[m]`` uses; ``create_fleet_state`` draws member m's init
    from it first, as ``build_model`` does);
  * the smoothing noise is drawn per member and stacked, the attack's
    uniform start drawn on the card from member m's seed;
  * the loss is each member's mean cross-entropy (plus its ss-loss), and
    one ``torch.autograd.grad`` of their sum gives each member its own
    gradient;
  * the switch and ensemble regimes draw per member, from generators
    seeded with member m's regime seeds (``ops/regimes.py``): a switch
    whose members chose solvers of one grid is one solve on their stacked
    tableau, so it launches what a standalone step does;
  * global-norm clipping, ``every_k``, the non-finite backoff,
    ``skip_nonfinite`` and the ``grad_norm`` metric are per member, and so
    are the optimizer's counts (the learning-rate schedule's step, the
    momentum schedule's, Adam's bias correction, ``every_k``'s phase, the
    backoff's scale): a member that ``skip_nonfinite`` skips keeps its
    params, optimizer state and model state, counts included, while the
    others step (``training/optimizers.py``); SGD, RMSprop and Adam run
    elementwise on the stacked tensors.

A stacked solver (``stack_fleet_solvers``) carries u and v of shape (S,);
each step moves them to the card once and builds the stacked (S, s, s)
tableau there once, and the RK combine scales member m's slice by its own
coefficients (``ops/integrate.py``).

``integration_method="adjoint"`` works as in a single run: the stacked
coefficients scale every leaf of the augmented state along the member
axis.

Numerics: member m matches its single run to float tolerance, not bit for
bit.  B1 and B3 give each member exactly a single launch's bits, but the
stem and the strided convs run as one grouped cuDNN conv (``groups=S``)
and the head as ``torch.bmm``, whose sums may be ordered otherwise.

The members over a mesh axis (JAX places the stacked state and inputs
with ``NamedSharding(mesh, P(axis))`` and the step compiles to per-device
member groups with no collectives): ``shard_fleet(tree, mesh, axis)``
gives this rank its contiguous S/k members of any stacked fleet tree (the
state, x, y, the generators, stacked solvers), the same step advances
them with no collective, and ``gather_fleet(metrics, mesh, axis)`` puts
the members' metrics back together in member order.

No counterpart: ``donate`` and ``compiler_options`` (nothing is compiled;
accepted and ignored, as ``unroll`` is).

A fleet step records the spans a single step does (``training/train.py``):
one ``train.step`` unit for all S members.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Any, List, Optional, Sequence

import torch

from ..attacks import attacks
from ..backend import full_f32, phase, span, spanned
from ..models.api import _flatten
from ..ops.noise import noise_solver
from ..ops.regimes import SolverOptions
from ..ops.solver import ParametricSolver
from ..parallel.mesh import host_local_batch_to_global
from .optimizers import global_norm, keep_members
from .train import (AttackConfig, LossConfig, NoiseConfig, TrainState,
                    _regime_generator, _regime_seeds, _run_attack, _seeds)

__all__ = [
    "fleet_generators",
    "create_fleet_state",
    "stack_fleet_solvers",
    "tile_fleet",
    "fleet_member",
    "shard_fleet",
    "gather_fleet",
    "make_fleet_train_step",
    "make_fleet_eval_step",
]


def fleet_generators(seeds: Sequence[int]) -> List[torch.Generator]:
    """One CPU generator per member (the counterpart of JAX's
    ``fleet_keys``): member i's is exactly the generator a single run
    seeded with ``seeds[i]`` uses."""
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def create_fleet_state(model, optimizer, seeds_or_generators=None, *,
                       state_dict=None) -> TrainState:
    """A TrainState whose params, optimizer buffers and model state carry a
    leading member axis.  Member i equals ``create_train_state`` of
    ``build_model`` with generator i (seeds are made generators by
    ``fleet_generators``), stacked; the generators advance as
    ``build_model`` advances them, so passing a run's generators here and
    then to the step gives each member its single run's stream.
    ``state_dict`` (stacked, by ``state_dict`` name, e.g.
    ``models.convert.stack_members``) starts the members from it
    instead."""
    if state_dict is None:
        gens = [g if isinstance(g, torch.Generator) else
                torch.Generator().manual_seed(int(g))
                for g in seeds_or_generators]
        members = [model.init_state_dict(g) for g in gens]
        flat = {k: torch.stack([m[k] for m in members])
                for k in members[0]}
    else:
        dev = model.device
        flat = {k: torch.as_tensor(v).to(dev, torch.float32).clone()
                for k, v in state_dict.items()}
    params = {k: v.requires_grad_(True) for k, v in flat.items()
              if k.startswith("params.")}
    model_state = {k: v for k, v in flat.items() if k.startswith("state.")}
    members = next(iter(params.values())).shape[0]
    return TrainState(0, params, optimizer.init(params, members),
                      model_state)


def stack_fleet_solvers(member_solvers: Sequence[Sequence[ParametricSolver]]
                        ) -> List[ParametricSolver]:
    """Stack per-member solver lists into one list of stacked solvers
    (u, v of shape (S,)), for a fleet step's ``dynamic_solvers``.

    ``member_solvers[i]`` is member i's list; all members must share the
    statics (method, parameterization, n_steps, step_size) and differ only
    in (u, v), as a u-sweep's do.  The other statics (u0, v0, the grid)
    are member 0's, as in JAX."""
    first = member_solvers[0]
    for ms in member_solvers[1:]:
        if len(ms) != len(first):
            raise ValueError("fleet members must have equal solver counts")
    stacked = []
    for j, base in enumerate(first):
        for ms in member_solvers[1:]:
            s = ms[j]
            if (s.method, s.parameterization, s.n_steps, s.step_size) != (
                    base.method, base.parameterization, base.n_steps,
                    base.step_size):
                raise ValueError(
                    "fleet members must share solver statics "
                    "(method/parameterization/n_steps/step_size); "
                    f"solver {j}: {s} vs {base}")
        stack = (lambda name: None if getattr(base, name) is None else
                 torch.stack([torch.as_tensor(getattr(ms[j], name))
                              for ms in member_solvers]))
        stacked.append(base.replace(u=stack("u"), v=stack("v")))
    return stacked


def tile_fleet(x, n_members: int) -> torch.Tensor:
    """One shared batch for every member: (B, ...) -> (S, B, ...),
    contiguous (the kernels read it as it lies)."""
    x = torch.as_tensor(x)
    return x.unsqueeze(0).expand((n_members,) + tuple(x.shape)).contiguous()


def fleet_member(tree: Any, i: int) -> Any:
    """Member i's slice of a stacked fleet tree (a TrainState, a dict of
    tensors, an optimizer state), for checkpointing or evaluating one
    member through the single-run harnesses: an optimizer state's
    per-member counts (lists of numbers) give member i's, as its single
    run's state holds them; other numbers stay."""
    if isinstance(tree, TrainState):
        return TrainState(tree.step, fleet_member(tree.params, i),
                          fleet_member(tree.opt_state, i),
                          fleet_member(tree.model_state, i))
    if isinstance(tree, torch.Tensor):
        return tree[i].detach()
    if isinstance(tree, dict):
        return {k: fleet_member(v, i) for k, v in tree.items()}
    if isinstance(tree, list) and tree and all(
            isinstance(v, (int, float)) for v in tree):
        return tree[i]
    if isinstance(tree, (list, tuple)):
        return type(tree)(fleet_member(v, i) for v in tree)
    return tree


def shard_fleet(tree: Any, mesh, axis: str = "fleet") -> Any:
    """This rank's contiguous members of a stacked fleet tree over the
    mesh ``axis`` (S members, k ranks: S/k each): tensors, per-member
    lists (counts, generators) and stacked solvers' u and v are cut along
    the member axis; other leaves stay.  Raises where S does not split."""
    shard = mesh.shard(axis)

    def cut(node):
        if isinstance(node, TrainState):
            return TrainState(node.step, cut(node.params),
                              cut(node.opt_state), cut(node.model_state))
        if isinstance(node, torch.Tensor):
            return node[shard.rows(node.shape[0])]
        if isinstance(node, dict):
            return {k: cut(v) for k, v in node.items()}
        if isinstance(node, ParametricSolver):
            return node.replace(**{
                k: cut(t) for k, t in (("u", node.u), ("v", node.v))
                if t is not None and t.dim() == 1})
        if isinstance(node, (list, tuple)) and node and all(
                isinstance(v, (int, float, torch.Generator)) for v in node):
            return type(node)(node[shard.rows(len(node))])
        if isinstance(node, (list, tuple)):
            return type(node)(cut(v) for v in node)
        return node

    return cut(tree)


def gather_fleet(tree: Any, mesh, axis: str = "fleet") -> Any:
    """The whole fleet's tensors (metrics, counts of an eval step) from
    every rank's members, in member order (an all-gather over the axis)."""
    if isinstance(tree, dict):
        return {k: gather_fleet(v, mesh, axis) for k, v in tree.items()}
    return host_local_batch_to_global(tree, mesh, axis)


class _Tabled(ParametricSolver):
    """A solver whose tableau was built once (the step's, on the card)."""

    def __init__(self, solver: ParametricSolver, tab):
        super().__init__(**{f.name: getattr(solver, f.name)
                            for f in fields(solver)})
        object.__setattr__(self, "_tab", tab)

    def tableau(self):
        return self._tab


def _member_solvers(base: Sequence[ParametricSolver], n: int,
                    noise_seeds: Optional[List[int]], noise_cfg: NoiseConfig,
                    device: torch.device) -> List[ParametricSolver]:
    """The step's stacked solvers on ``device``, each tableau built once
    there: with smoothing noise, member m's (u, v) drawn from its own
    noise seed around the solver's (u0, v0), as a single step draws them;
    else the given u, v (stacked (S,), or one value for every member)."""
    # one noise generator a member, drawn solver after solver as a single
    # step draws them
    gens = (None if noise_seeds is None else
            [torch.Generator().manual_seed(seed) for seed in noise_seeds])
    out = []
    for s in base:
        if gens is not None and s.u0 is not None:
            drawn = [noise_solver(s, g, std=noise_cfg.sigma,
                                  bernoulli_p=noise_cfg.prob,
                                  noise_type=noise_cfg.noise_type,
                                  minimize_rk2_error=
                                  noise_cfg.minimize_rk2_error)
                     for g in gens]
            u = torch.stack([d.u for d in drawn])
            v = None if s.v is None else torch.stack([d.v for d in drawn])
        else:
            widen = (lambda t: None if t is None else
                     t.reshape(-1).expand(n) if t.numel() == 1 else t)
            u, v = widen(s.u), widen(s.v)
        move = lambda t: None if t is None else t.to(device,
                                                     non_blocking=True)
        s = s.replace(u=move(u), v=move(v))
        out.append(_Tabled(s, s.tableau()) if s.u is not None else s)
    return out


def _fleet_forward(model, solver_options: SolverOptions, use_kernels: bool,
                   compute_dtype: Optional[torch.dtype], remat: bool,
                   integration_method: str):
    """``forward(x, solvers, train, params, state, ss=None,
    generators=None) -> (logits, ss, new_state)``: the members' forward of
    x (S, N, ...), logits (S, N, K) and ss (S,) in f32, ``new_state`` flat
    by buffer name; ``generators`` (one a member, or None) serve the
    regime draws."""

    def forward(x, solvers_t, train, params, state, ss=None,
                generators=None):
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        want_ss = ss is not None and ss.ss_loss
        logits, aux = model(
            x, solvers_t, solver_options, use_kernels=use_kernels,
            train=train, params=model.param_tree(params),
            model_state=model.state_tree(state), remat=remat,
            generator=generators, ss_loss=want_ss,
            ss_loss_abs=want_ss and ss.ss_loss_abs,
            integration_method=integration_method, return_aux=True)
        ss_val = (aux["ss_loss"].float() if want_ss else
                  torch.zeros(x.shape[0], device=logits.device))
        return logits.float(), ss_val, _flatten(aux["model_state"],
                                                "state", {})

    return forward


def make_fleet_train_step(model, optimizer, solvers: Sequence,
                          solver_options: SolverOptions = SolverOptions(),
                          attack_cfg: AttackConfig = AttackConfig(),
                          noise_cfg: NoiseConfig = NoiseConfig(),
                          loss_cfg: LossConfig = LossConfig(), *,
                          remat: bool = False, unroll: int = 1,
                          compute_dtype: Optional[torch.dtype] = None,
                          skip_nonfinite: bool = False,
                          use_kernels: bool = True,
                          integration_method: str = "backprop",
                          donate: bool = True,
                          compiler_options: Optional[dict] = None):
    """Returns ``step(fleet_state, x, y, generators, dynamic_solvers=None)
    -> (fleet_state, metrics)``.

    ``fleet_state`` from ``create_fleet_state``; x (S, B, H, W, C) and y
    (S, B) on the model's device, each member's own batch; ``generators``
    the members' CPU generators (``fleet_generators``); ``dynamic_solvers``
    (``stack_fleet_solvers``) gives each member its own coefficients.
    Metrics are (S,) tensors: loss, xentropy, ss_loss, accuracy,
    grad_norm (each member's global norm) and, with ``skip_nonfinite``,
    skipped_nonfinite (a member with a non-finite loss or gradient keeps
    its params, optimizer state and model state, and its backoff records
    the skip; the check reads the members' flags back to the host).  The
    keyword arguments are ``make_train_step``'s; ``donate``,
    ``compiler_options`` and ``unroll`` have no counterpart and are
    ignored."""
    del unroll, donate, compiler_options
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype} not supported")
    forward = _fleet_forward(model, solver_options, use_kernels,
                             compute_dtype, remat, integration_method)

    @spanned("train.step", unit=True)
    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
             generators: Sequence[torch.Generator], dynamic_solvers=None):
        n = x.shape[0]
        if len(generators) != n:
            raise ValueError(f"{len(generators)} generators for {n} members")
        with span("train.draws"):
            # member m's three step seeds, then its two regime seeds (None
            # under standalone, which draws none), as a single step draws
            # them
            seeds = [_seeds(g, 3) + _regime_seeds(g, solver_options, 2)
                     for g in generators]
            base = (solvers if dynamic_solvers is None
                    else list(dynamic_solvers))
            solvers_t = _member_solvers(
                base, n, None if noise_cfg.noise_type is None
                else [s[0] for s in seeds], noise_cfg, x.device)
        params = state.params
        with full_f32():
            with phase("nodems.attack"):
                frozen = {k: v.detach() for k, v in params.items()}
                x_adv = _run_attack(
                    lambda xi, g: forward(xi, solvers_t, False, frozen,
                                          state.model_state,
                                          generators=g)[0],
                    attack_cfg, x, y,
                    [torch.Generator(device=x.device).manual_seed(s[1])
                     for s in seeds], [s[3] for s in seeds])
            if loss_cfg.data_noise_std > 1e-12:
                noise = torch.stack([torch.randn(
                    x_adv.shape[1:], generator=torch.Generator(
                        device=x.device).manual_seed(s[2]),
                    dtype=x_adv.dtype, device=x.device) for s in seeds])
                x_adv = x_adv + loss_cfg.data_noise_std * noise
            with phase("nodems.train_pass"), torch.enable_grad():
                logits, ss, new_state = forward(
                    x_adv, solvers_t, True, params, state.model_state,
                    ss=loss_cfg,
                    generators=_regime_generator([s[4] for s in seeds]))
                xent = attacks.member_cross_entropy(logits, y)
                loss = xent
                if loss_cfg.ss_loss:
                    loss = loss + loss_cfg.ss_loss_reg * ss
                with span("train.backward"):
                    grads = torch.autograd.grad(loss.sum(),
                                                list(params.values()))
            gnorm = global_norm(grads, n)
            metrics = {"loss": loss.detach(), "xentropy": xent.detach(),
                       "ss_loss": ss.detach(),
                       "accuracy": (logits.argmax(-1) == y).float().mean(1),
                       "grad_norm": gnorm}
            ok = None
            if skip_nonfinite:
                flags = torch.isfinite(loss.detach()) & torch.isfinite(gnorm)
                metrics["skipped_nonfinite"] = (~flags).float()
                ok = flags.tolist()
                if all(ok):
                    ok = None
            with phase("nodems.update"):
                optimizer.update(params, grads, state.opt_state, members=n,
                                 skip=None if ok is None
                                 else [not v for v in ok])
                # a skipped member keeps its model state too
                buffers = list(state.model_state.values())
                old = (None if ok is None else
                       [t.detach().clone() for t in buffers])
                with torch.no_grad():
                    for k, buf in state.model_state.items():
                        buf.copy_(new_state[k])
                if old is not None:
                    keep_members(buffers, old, ok)
        return TrainState(state.step + 1, params, state.opt_state,
                          state.model_state), metrics

    return step


def make_fleet_eval_step(model, solvers: Sequence,
                         solver_options: SolverOptions = SolverOptions(), *,
                         attack_cfg: Optional[AttackConfig] = None,
                         remat: bool = False, unroll: int = 1,
                         compute_dtype: Optional[torch.dtype] = None,
                         use_kernels: bool = True,
                         compiler_options: Optional[dict] = None):
    """Returns ``counts(params, model_state, x, y, generators=None,
    dynamic_solvers=None) -> (S,)`` int64: each member's correct
    predictions on its batch x (S, B, ...) (stacked, or one batch made
    S by ``tile_fleet``), y (S, B), through its own params and state (a
    fleet state's ``params`` and ``model_state``) and, with
    ``dynamic_solvers``, its own coefficients.

    ``attack_cfg=None`` (or mode "clean") counts clean predictions;
    member m draws from ``generators[m]`` the regime seed of the switch
    and ensemble regimes (standalone draws nothing) as ``accuracy`` draws
    a batch's.  Otherwise each member's batch is attacked through its own
    params first, and member m draws its attack seed, then its regime
    seed, as ``adversarial_accuracy`` draws a batch's.  Either way the
    counts equal that harness's on member m.  Accumulate the counts on the
    card and divide at the end."""
    del unroll, compiler_options
    forward = _fleet_forward(model, solver_options, use_kernels,
                             compute_dtype, remat, "backprop")
    attacked = attack_cfg is not None and attack_cfg.mode != "clean"

    def counts(params, model_state, x, y, generators=None,
               dynamic_solvers=None) -> torch.Tensor:
        n = x.shape[0]
        base = solvers if dynamic_solvers is None else list(dynamic_solvers)
        solvers_t = _member_solvers(base, n, None, NoiseConfig(), x.device)
        frozen = {k: v.detach() for k, v in params.items()}
        drawn = attacked or solver_options.solver_mode != "standalone"
        if drawn and (generators is None or len(generators) != n):
            what = "an attacked" if attacked else solver_options.solver_mode
            raise ValueError(f"{what} fleet eval needs one CPU generator "
                             "per member")
        seeds = ([int(torch.randint(0, 2 ** 62, (), generator=g))
                  for g in generators] if attacked else None)
        fwd_seeds = ([_regime_seeds(g, solver_options, 1)[0]
                      for g in generators] if drawn else None)
        with full_f32():
            if attacked:
                x = _run_attack(
                    lambda xi, g: forward(xi, solvers_t, False, frozen,
                                          model_state, generators=g)[0],
                    attack_cfg, x, y,
                    [torch.Generator(device=x.device).manual_seed(s)
                     for s in seeds], fwd_seeds)
            with torch.inference_mode():
                logits = forward(x, solvers_t, False, frozen, model_state,
                                 generators=_regime_generator(fwd_seeds))[0]
                return (logits.argmax(-1) == y).sum(1)

    return counts

