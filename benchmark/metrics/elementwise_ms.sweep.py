"""Device ms a step of every kernel that no kernel class and no cuDNN or
cuBLAS pattern claims (copies and fills left out): autograd's, the Python
RK loop's and the activations' elementwise work."""
from benchmark.harness import layers


def read(ctx):
    return layers.elementwise_ms(ctx)
