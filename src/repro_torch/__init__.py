"""PyTorch/CUDA port of the Fed-TGAN system, beside the JAX package ``repro``.

Module names mirror ``repro``.  This package imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.  Its entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU, where every kernel
runs as its plain PyTorch version.
"""
