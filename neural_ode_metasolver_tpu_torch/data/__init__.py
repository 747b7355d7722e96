"""Data layer of the port (mirrors the JAX ``data``): on-disk MNIST /
CIFAR-10 / SVHN readers, synthetic and digits fallbacks,
torchvision-parity augmentation, batching, and the prefetch to the card.
Nothing is downloaded."""
from .datasets import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    Dataset,
    augment_batch,
    batch_iterator,
    data_backend,
    inf_generator,
    load_cifar10,
    load_digits_dataset,
    load_mnist,
    load_svhn,
    normalize_images,
    synthetic_dataset,
    train_val_split,
)
from .prefetch import prefetch_to_device, threaded_iterator

__all__ = [
    "CIFAR10_MEAN",
    "CIFAR10_STD",
    "Dataset",
    "augment_batch",
    "batch_iterator",
    "data_backend",
    "inf_generator",
    "load_cifar10",
    "load_digits_dataset",
    "load_mnist",
    "load_svhn",
    "normalize_images",
    "prefetch_to_device",
    "threaded_iterator",
    "synthetic_dataset",
    "train_val_split",
]
