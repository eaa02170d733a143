"""The JAX package's random draws, reproduced from its key splits as numpy
and handed to the port as tensors, so that both packages compute from the
same noise.  Each helper names the reference code whose splits it follows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.gan.trainer import StepNoise
from repro_torch.synth import SamplerDraws


def t(a):
    return torch.from_numpy(np.array(a))


def activation_uniforms(key, spans, n, dim):
    """``kernels/ops.py:segment_activations``: span i draws
    ``uniform(split(key, S)[i], (n, w_i))``; laid out in the encoded row,
    tanh spans 0.5."""
    u = np.full((n, dim), 0.5, np.float32)
    for s, k in zip(spans, jax.random.split(key, len(spans))):
        if s.activation != "tanh":
            u[:, s.start:s.start + s.width] = np.asarray(
                jax.random.uniform(k, (n, s.width), jnp.float32))
    return torch.from_numpy(u)


def sampler_draws(key, n, n_spans):
    """``synth/sampler.py:draw_batch``: span ids, category and row
    uniforms from ``split(key, 3)``."""
    k_span, k_cat, k_row = jax.random.split(key, 3)
    return SamplerDraws(t(jax.random.randint(k_span, (n,), 0, n_spans)),
                        t(jax.random.uniform(k_cat, (n,))),
                        t(jax.random.uniform(k_row, (n,))))


def dropout_keeps(key, cfg, batch):
    """``gan/ctgan.py:discriminator_forward``: layer i keeps
    ``bernoulli(split(key, L)[i], 1 - dropout, (batch/pac, h_i))``."""
    keys = jax.random.split(key, len(cfg.disc_hidden))
    return [t(jax.random.bernoulli(k, 1 - cfg.dropout,
                                   (batch // cfg.pac, h)))
            for k, h in zip(keys, cfg.disc_hidden)]


def _noise(kd, kg, cfg, spans, batch, dim):
    """One step's :class:`StepNoise` from the critic's and the generator's
    keys: the critic's key splits 5 ways (z, activations, two dropouts,
    GP), the GP's 2 ways (eps, unused); the generator's 3 ways (z,
    activations, dropout)."""
    kz, ka, kd1, kd2, kgp = jax.random.split(kd, 5)
    keps, _ = jax.random.split(kgp)
    gz, ga, gd = jax.random.split(kg, 3)
    return StepNoise(
        z_d=t(jax.random.normal(kz, (batch, cfg.z_dim))),
        u_d=activation_uniforms(ka, spans, batch, dim),
        keep_d_fake=dropout_keeps(kd1, cfg, batch),
        keep_d_real=dropout_keeps(kd2, cfg, batch),
        gp_eps=t(jax.random.uniform(keps, (batch // cfg.pac, 1, 1))),
        z_g=t(jax.random.normal(gz, (batch, cfg.z_dim))),
        u_g=activation_uniforms(ga, spans, batch, dim),
        keep_g=dropout_keeps(gd, cfg, batch))


def step_noise(rng, cfg, spans, batch, dim):
    """``gan/trainer.py:make_train_steps``: one step's draws from the
    state's key, and the key the state carries on.  ``split(rng, 3)`` ->
    (next, critic, generator), then :func:`_noise`."""
    nxt, kd, kg = jax.random.split(rng, 3)
    return _noise(kd, kg, cfg, spans, batch, dim), nxt


def round_noise(rng, cfg, spans, batch, dim, steps):
    """``steps`` consecutive steps' :func:`step_noise` of one client."""
    return rounds_noise(rng, cfg, spans, batch, dim, steps, 1)[0]


def rounds_noise(rng, cfg, spans, batch, dim, steps, rounds):
    """``rounds`` consecutive local rounds' :func:`step_noise` of one
    client (the state's key carries on from round to round)."""
    out = []
    for _ in range(rounds):
        this = []
        for _ in range(steps):
            noise, rng = step_noise(rng, cfg, spans, batch, dim)
            this.append(noise)
        out.append(this)
    return out


def md_step_draws(key, cfg, spans, batch, dim, n_spans, n_clients):
    """``core/architectures.py:run_mdtgan``'s ``md_step``: ``split(key)``
    -> (key, batches); client p's batch from ``split(batches, P)[p]``;
    ``split(key, P + 1)``: client p's critic key, and the generator's,
    split P ways, client p's generator key.  Returns (per-client
    :class:`SamplerDraws`, per-client :class:`StepNoise`)."""
    key, kb = jax.random.split(key)
    draws = [sampler_draws(k, batch, n_spans)
             for k in jax.random.split(kb, n_clients)]
    kd = jax.random.split(key, n_clients + 1)
    ks = jax.random.split(kd[n_clients], n_clients)
    return draws, [_noise(kd[p], ks[p], cfg, spans, batch, dim)
                   for p in range(n_clients)]


def dp_step_noise(rng, cfg, spans, batch, dim, disc):
    """``gan/dp.py:make_dp_train_steps``: ``split(rng, 6)`` -> (next, z,
    activations, packs, Gaussians, generator).  Pack i's key is
    ``split(packs, B/pac)[i]``, split 3 ways (fake dropout, real dropout,
    penalty; the penalty's 2 ways: eps, unused); the Gaussians' key splits
    once per critic leaf in ``jax.tree`` order (sorted keys: ``fc0/b``,
    ``fc0/w``, ...), each drawn in the reference's ``(fan_in, fan_out)``
    layout and handed over in ``disc.parameters()`` order, transposed as
    the port stores it; the generator's key splits 3 ways as in
    :func:`_noise`.  Returns (the :class:`DPStepNoise`, the key the state carries on)."""
    from repro_torch.gan.dp import DPStepNoise
    from repro_torch.interop import _layout
    nxt, kz, ka, kd, kn, kg = jax.random.split(rng, 6)
    n_packs = batch // cfg.pac
    keep_f, keep_r, eps = [], [], []
    for pk in jax.random.split(kd, n_packs):
        k1, k2, kgp = jax.random.split(pk, 3)
        keep_f.append(dropout_keeps(k1, cfg, cfg.pac))
        keep_r.append(dropout_keeps(k2, cfg, cfg.pac))
        keps, _ = jax.random.split(kgp)
        eps.append(np.asarray(jax.random.uniform(keps, (1, 1, 1))))
    layout = _layout(disc)
    keys = dict(zip(sorted(key for _, key, _ in layout),
                    jax.random.split(kn, len(layout))))
    d_noise = []
    for param, key, transposed in layout:
        shape = tuple(param.shape[::-1]) if transposed else tuple(param.shape)
        a = np.asarray(jax.random.normal(keys[key], shape, jnp.float32))
        d_noise.append(torch.from_numpy(np.array(a.T if transposed else a,
                                                 order="C")))
    gz, ga, gd = jax.random.split(kg, 3)
    return DPStepNoise(
        z_d=t(jax.random.normal(kz, (batch, cfg.z_dim))),
        u_d=activation_uniforms(ka, spans, batch, dim),
        keep_d_fake=[torch.cat(layer) for layer in zip(*keep_f)],
        keep_d_real=[torch.cat(layer) for layer in zip(*keep_r)],
        gp_eps=torch.from_numpy(np.concatenate(eps)),
        z_g=t(jax.random.normal(gz, (batch, cfg.z_dim))),
        u_g=activation_uniforms(ga, spans, batch, dim),
        keep_g=dropout_keeps(gd, cfg, batch), d_noise=d_noise), nxt
