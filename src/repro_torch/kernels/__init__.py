"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref``) and the router between them (``ops``)."""
