"""The benchmark's frozen yardstick of work: the H100's peaks, the least
bytes and operations of the kernels its rooflines read, and CTGAN's model
FLOPs.

The kernel formulas follow the port's ``kernels/work.py`` as it stood
when the benchmark was defined: bytes count each input read once and
each output written once, operations what the call's inputs need; the
activations count the encoded row's lanes, not the kernels' padded
layout.
A later change to the program cannot change them.
"""
from __future__ import annotations

from typing import Sequence

F32 = 4

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.  The
# port keeps TF32 off, so CTGAN's float32 products run on the CUDA cores.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(n_bytes: float, flops: float) -> float:
    """The larger of the bytes' and the operations' time at the peaks."""
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def segment_activations(b: int, widths: Sequence[int],
                        backward: bool = False) -> tuple[int, int]:
    """``b`` rows of the encoded row's spans of ``widths`` lanes: the
    logits and uniforms in and the activations out, one kind a span; the
    backward also reads the cotangent and writes the gradient.  The lanes
    counted are the row's own, ``b * sum(widths)``: the kernels' packed
    layout pads every span to the widest, and that padding is not work
    the function needs.  Returns (bytes, flops)."""
    lanes, spans = b * sum(widths), len(widths)
    if backward:
        return F32 * (4 * lanes + spans), lanes * 16
    return F32 * (3 * lanes + spans), lanes * 12


def vgm_decode_table(b: int, q: int, k: int) -> tuple[int, int]:
    """``b`` rows of ``q`` columns' (1 + k) slots and the modes' means and
    stds in, the decoded values out.  Returns (bytes, flops)."""
    return F32 * (b * q * (1 + k) + 2 * q * k + b * q), b * q * (k + 4)


def _dense(rows: int, dims: Sequence[tuple[int, int]]) -> int:
    return sum(2 * rows * i * o for i, o in dims)


def _generator_dims(z_dim: int, gen_hidden: Sequence[int], data_dim: int,
                    cond_dim: int) -> list[tuple[int, int]]:
    """(fan in, fan out) of the generator's linear layers: each residual
    block's input is every earlier block's output beside (z, cond)."""
    dims, width = [], z_dim + cond_dim
    for h in gen_hidden:
        dims.append((width, h))
        width += h
    return dims + [(width, data_dim)]


def ctgan_step_flops(*, z_dim: int, gen_hidden: Sequence[int],
                     disc_hidden: Sequence[int], pac: int, batch: int,
                     data_dim: int, cond_dim: int) -> dict:
    """The matrix products of one CTGAN train step (a critic update with
    WGAN-GP, then a generator update), as float32 FLOPs.

    ``model``: what the losses need: the generator forward twice and its
    backward once (weight gradients, and input gradients for every layer
    but the first); the critic forward on the fakes, the reals and the
    interpolates; the penalty's input gradient through the critic, and its
    double backward (the input-gradient products differentiated for the
    upstream gradient and for the weights); the WGAN term's weight
    gradients through both critic passes; the generator's critic pass and
    its input gradient.  Nothing is recomputed.

    ``zero_grad``: products autograd also runs in the double backward with
    gradients that are exactly zero (the leaky ReLU's derivative is flat,
    yet autograd carries its zeros into the critic's forward graph: the
    hidden layers' weight gradients and the input gradients of all but the
    first).  They are not model FLOPs.  ``model + zero_grad`` is what a
    dispatch-mode count of the step's products reads."""
    b = batch // pac
    g_dims = _generator_dims(z_dim, gen_hidden, data_dim, cond_dim)
    d_dims, width = [], pac * (data_dim + cond_dim)
    for h in disc_hidden:
        d_dims.append((width, h))
        width = h
    d_dims.append((width, 1))

    g_fwd = _dense(batch, g_dims)
    g_in = _dense(batch, g_dims[1:])            # no gradient into (z, cond)
    d_fwd = _dense(b, d_dims)
    d_in_rest = _dense(b, d_dims[1:])
    d_out = _dense(b, d_dims[-1:])
    critic = (g_fwd                             # fakes, no graph
              + 3 * d_fwd                       # fakes, reals, interpolates
              + d_fwd                           # penalty: input gradient
              + 2 * (d_fwd + d_in_rest)         # WGAN: both passes' backward
              + (d_fwd - d_out) + d_fwd)        # penalty: double backward
    generator = (g_fwd + d_fwd                  # fakes through the critic
                 + d_fwd                        # critic: input gradient
                 + g_fwd + g_in)                # generator backward
    zero_grad = (d_fwd - d_out) + (d_in_rest - d_out)
    return {"model": critic + generator, "zero_grad": zero_grad}


def ctgan_generator_flops(*, z_dim: int, gen_hidden: Sequence[int],
                          rows: int, data_dim: int, cond_dim: int) -> int:
    """The matrix products of one generator forward over ``rows`` rows
    (serving: one per request, at its bucket's size)."""
    return _dense(rows, _generator_dims(z_dim, gen_hidden, data_dim,
                                        cond_dim))
