"""The benchmark of the PyTorch/CUDA port (see ``run.py``)."""
