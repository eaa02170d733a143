"""The benchmark of the PyTorch and CUDA port, ``repro_torch``, on NVIDIA
H100 cards (see ``README.md``)."""
