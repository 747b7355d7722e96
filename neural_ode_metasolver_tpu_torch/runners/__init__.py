"""The port's CLIs (mirrors the JAX ``runners``): ``mnist_runner``,
``cifar_runner``, ``attacks_runner``, ``sweep`` (a grid over the first two)
and ``u_sweep`` (the MNIST u-sweep, sequential or as a fleet)."""
