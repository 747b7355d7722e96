"""The port's CLIs (mirrors the JAX ``runners``): ``mnist_runner``,
``cifar_runner`` and ``attacks_runner``; ``sweep`` and ``u_sweep`` wait for
the fleet (ROADMAP A20)."""
