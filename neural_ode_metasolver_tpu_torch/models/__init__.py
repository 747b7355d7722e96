"""Models of the PyTorch port (mirrors the JAX ``models``)."""
from .api import Model, build_model, make_cifar_model
from .convert import (
    cifar_params_from_jax,
    cifar_state_from_jax,
    mnist_params_from_jax,
    rmsprop_state_from_jax,
    stack_members,
)
from .odenet_cifar10 import (
    MODEL_REGISTRY,
    CifarConfig,
    apply_cifar,
    init_cifar,
    metanode4,
    metanode6,
    metanode10,
    metanode18,
    metanode34,
    premetanode4,
    premetanode6,
    premetanode10,
    premetanode18,
    premetanode34,
)
from .odenet_mnist import MnistConfig, apply_mnist, init_mnist
from .torch_export import (
    cifar_state_dict_from_params,
    mnist_state_dict_from_params,
    reference_wandb_config,
    save_cifar_reference_checkpoint,
    save_mnist_reference_checkpoint,
)
from .torch_import import (
    cifar_params_from_torch_state_dict,
    mnist_params_from_torch_state_dict,
)

__all__ = [
    "MODEL_REGISTRY",
    "CifarConfig",
    "MnistConfig",
    "Model",
    "apply_cifar",
    "apply_mnist",
    "build_model",
    "make_cifar_model",
    "cifar_params_from_jax",
    "cifar_params_from_torch_state_dict",
    "cifar_state_dict_from_params",
    "cifar_state_from_jax",
    "init_cifar",
    "init_mnist",
    "metanode4",
    "metanode6",
    "metanode10",
    "metanode18",
    "metanode34",
    "mnist_params_from_jax",
    "mnist_params_from_torch_state_dict",
    "mnist_state_dict_from_params",
    "premetanode4",
    "premetanode6",
    "premetanode10",
    "premetanode18",
    "premetanode34",
    "reference_wandb_config",
    "rmsprop_state_from_jax",
    "save_cifar_reference_checkpoint",
    "save_mnist_reference_checkpoint",
    "stack_members",
]
