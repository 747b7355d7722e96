"""Learn the RK2 coefficient u by gradient descent on integration error, on
the PyTorch port -- the port's counterpart of
``examples/learn_solver_coefficient.py``.

The framework's core premise is that the solver itself is a differentiable,
parametrized object.  This demo trains u (only u, no network) to minimize
the gap between a coarse RK2(u) solve and a fine reference solve of random
nonlinear ODEs, with torch autograd through the port's ``odeint_final`` and
``rk2_tableau``.  Classical numerical analysis says u = 2/3 minimizes the
dominant RK2 local-truncation-error term; gradient descent through the
integrator moves u from its 0.25 start toward that region (the exact
optimum depends on the problem family).

    python examples/torch/learn_solver_coefficient.py [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given, and raises
without a card.  The last line printed is a JSON record of the run (with
the kernels' launches: none here, as the solve calls no model).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch

from neural_ode_metasolver_tpu_torch import launch_counts, resolve_device
from neural_ode_metasolver_tpu_torch.ops import odeint_final, rk2_tableau


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' for the CPU; the default is the CUDA card")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--u0", type=float, default=0.25)
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device)

    def rhs(a, t, y):
        # a family of smooth nonlinear ODEs parametrized by a
        return torch.tanh(a[0] * y) + a[1] * torch.sin(2.0 * t + a[2])

    # the fine solve's coefficient: the optimum of the truncation error
    u_fine = torch.tensor(2 / 3, device=device)

    def loss_fn(u, generator):
        a = torch.randn(3, generator=generator).to(device)
        y0 = torch.randn(8, generator=generator).to(device)
        f = lambda t, y: rhs(a, t, y)  # noqa: E731
        coarse = odeint_final(rk2_tableau(u), f, y0, 0.0, 1.0, n_steps=4)
        with torch.no_grad():  # the reference takes no gradient
            fine = odeint_final(rk2_tableau(u_fine), f, y0, 0.0, 1.0,
                                n_steps=256)
        return torch.mean((coarse - fine) ** 2)

    u = torch.tensor(args.u0, device=device, requires_grad=True)
    opt = torch.optim.Adam([u], lr=3e-3)
    generator = torch.Generator().manual_seed(0)
    loss = None
    for i in range(args.steps):
        opt.zero_grad()
        loss = loss_fn(u, generator)
        loss.backward()
        opt.step()
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  u = {u.item():.4f}  loss = "
                  f"{loss.item():.3e}")
    print(f"\nlearned u = {u.item():.4f}   (theory: 2/3 = {2 / 3:.4f})")
    print(json.dumps({"example": "learn_solver_coefficient",
                      "device": str(device), "steps": args.steps,
                      "u0": args.u0, "u": u.item(),
                      "final_loss": loss.item() if loss is not None
                      else None, "launches": launch_counts(),
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
