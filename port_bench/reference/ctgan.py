"""Plain reference of CTGAN (Xu et al., 2019) and of Fed-TGAN's round,
torch only, float32, written from the papers' equations as functions of a
parameter dict.

* Generator: ``h = [z, cond]``; per hidden width a residual block
  ``h = [h, relu(bn(W h + b))]`` with batch norm over the batch at hand
  (biased variance, eps 1e-5); then a linear layer to the encoded row.
* Head: tanh on each alpha, Gumbel-softmax (temperature tau) on each mode
  and category span; hard samples take the one-hot of the argmax.
* Critic (PacGAN): ``pac`` rows concatenated; per hidden width a linear
  layer, LeakyReLU(0.2) and dropout (keep masks given, kept units scaled
  by 1 / (1 - p)); a linear layer to one score.
* A train step: the critic's WGAN loss plus ``gp_lambda`` times the
  pac-aware gradient penalty (the critic without dropout on interpolates),
  one Adam update; then the generator's ``-mean(critic(fake)) +``
  conditional cross-entropy against the critic just updated, one Adam
  update.  Adam: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
  ``p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + 1e-8)``.
* A Fed-TGAN round: every client's local steps, then the weighted average
  of all parameters (generator and critic) copied back to every client;
  the optimizer moments stay with each client.

Parameter names follow the state-dict layout of the measured program's
modules (``gen.res.<i>.fc.weight``, ``disc.fc.<i>.weight``, ...), so that
the benchmark can hand both the same weights by name.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GUMBEL_EPS = 1e-20


def param_layout(cfg: dict, data_dim: int, cond_dim: int
                 ) -> list[tuple[str, tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every parameter, generator then
    critic; kind is "weight", "bias", "bn_scale" or "bn_bias"."""
    out, width = [], cfg["z_dim"] + cond_dim
    for i, h in enumerate(cfg["gen_hidden"]):
        out += [(f"gen.res.{i}.fc.weight", (h, width), "weight", width),
                (f"gen.res.{i}.fc.bias", (h,), "bias", width),
                (f"gen.res.{i}.bn_scale", (h,), "bn_scale", 0),
                (f"gen.res.{i}.bn_bias", (h,), "bn_bias", 0)]
        width += h
    out += [("gen.out.weight", (data_dim, width), "weight", width),
            ("gen.out.bias", (data_dim,), "bias", width)]
    width = cfg["pac"] * (data_dim + cond_dim)
    for i, h in enumerate(cfg["disc_hidden"]):
        out += [(f"disc.fc.{i}.weight", (h, width), "weight", width),
                (f"disc.fc.{i}.bias", (h,), "bias", width)]
        width = h
    out += [("disc.out.weight", (1, width), "weight", width),
            ("disc.out.bias", (1,), "bias", width)]
    return out


def make_weights(layout, g: torch.Generator, device) -> torch.Tensor:
    """Every parameter in one flat float32 vector, from ONE uniform draw:
    weights and biases uniform in +-1/sqrt(fan_in), batch-norm scales 1
    and shifts 0."""
    n = sum(math.prod(s) for _, s, _, _ in layout)
    flat = torch.rand(n, generator=g, device=device) * 2.0 - 1.0
    off = 0
    for _, shape, kind, fan_in in layout:
        seg = flat[off:off + math.prod(shape)]
        if kind in ("weight", "bias"):
            seg.mul_(1.0 / math.sqrt(fan_in))
        else:
            seg.fill_(1.0 if kind == "bn_scale" else 0.0)
        off += seg.numel()
    return flat


def unflatten(flat: torch.Tensor, layout) -> dict:
    out, off = {}, 0
    for name, shape, _, _ in layout:
        k = math.prod(shape)
        out[name] = flat[off:off + k].view(shape)
        off += k
    return out


def generator(p: dict, z: torch.Tensor, cond: torch.Tensor,
              n_blocks: int) -> torch.Tensor:
    h = torch.cat([z, cond], dim=1)
    for i in range(n_blocks):
        y = F.linear(h, p[f"gen.res.{i}.fc.weight"], p[f"gen.res.{i}.fc.bias"])
        mu = torch.mean(y, dim=0, keepdim=True)
        var = torch.var(y, dim=0, keepdim=True, correction=0)
        y = ((y - mu) / torch.sqrt(var + 1e-5) * p[f"gen.res.{i}.bn_scale"]
             + p[f"gen.res.{i}.bn_bias"])
        h = torch.cat([h, torch.relu(y)], dim=1)
    return F.linear(h, p["gen.out.weight"], p["gen.out.bias"])


def activations(logits: torch.Tensor, spans, u: torch.Tensor, tau: float,
                hard: bool = False) -> torch.Tensor:
    """``spans``: (start, width, "tanh" | "softmax", _); ``u`` the uniforms
    in the encoded row's layout."""
    parts = []
    for start, width, kind, _ in spans:
        x = logits[:, start:start + width]
        if kind == "tanh":
            parts.append(torch.tanh(x))
            continue
        g = -torch.log(-torch.log(u[:, start:start + width] + GUMBEL_EPS)
                       + GUMBEL_EPS)
        y = torch.softmax((x + g) / tau, dim=1)
        if hard:
            y = F.one_hot(torch.argmax(y, dim=1), width).float()
        parts.append(y)
    return torch.cat(parts, dim=1)


def critic(p: dict, x: torch.Tensor, pac: int, n_hidden: int,
           dropout: float, keep=None) -> torch.Tensor:
    h = x.reshape(x.shape[0] // pac, -1)
    for i in range(n_hidden):
        h = F.leaky_relu(F.linear(h, p[f"disc.fc.{i}.weight"],
                                  p[f"disc.fc.{i}.bias"]), 0.2)
        if keep is not None:
            h = torch.where(keep[i], h / (1.0 - dropout), 0.0)
    return F.linear(h, p["disc.out.weight"], p["disc.out.bias"])[:, 0]


def gradient_penalty(p: dict, real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor, pac: int, n_hidden: int
                     ) -> torch.Tensor:
    b = real.shape[0] // pac
    inter = (eps * real.reshape(b, pac, -1)
             + (1 - eps) * fake.reshape(b, pac, -1)).reshape(real.shape)
    inter = inter.detach().requires_grad_()
    score = torch.sum(critic(p, inter, pac, n_hidden, 0.0))
    (g,) = torch.autograd.grad(score, inter, create_graph=True)
    gn = torch.sqrt(torch.sum(g.reshape(b, -1) ** 2, dim=1) + 1e-12)
    return torch.mean((gn - 1.0) ** 2)


def conditional_loss(logits: torch.Tensor, cond: torch.Tensor,
                     mask: torch.Tensor, cond_spans) -> torch.Tensor:
    total = torch.zeros(logits.shape[0], device=logits.device)
    pos = 0
    for si, (start, width, _, _) in enumerate(cond_spans):
        logp = F.log_softmax(logits[:, start:start + width], dim=1)
        total = total + (-torch.sum(cond[:, pos:pos + width] * logp, dim=1)
                         * mask[:, si])
        pos += width
    return torch.mean(total)


class Adam:
    def __init__(self, cfg: dict, params: list[torch.Tensor]):
        self.lr, self.b1, self.b2 = cfg["lr"], cfg["b1"], cfg["b2"]
        self.m = [torch.zeros_like(t) for t in params]
        self.v = [torch.zeros_like(t) for t in params]
        self.t = 0

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor]):
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g * (1.0 - self.b1))
            v.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            p.sub_(self.lr * (m / bc1) / (torch.sqrt(v / bc2) + 1e-8))


class Client:
    """One data owner's copy of the models and its two optimizers."""

    def __init__(self, cfg: dict, flat: torch.Tensor, layout):
        self.cfg = cfg
        self.p = {k: t.clone() for k, t in unflatten(flat, layout).items()}
        self.gen_names = [n for n, *_ in layout if n.startswith("gen.")]
        self.disc_names = [n for n, *_ in layout if n.startswith("disc.")]
        self.g_opt = Adam(cfg, [self.p[n] for n in self.gen_names])
        self.d_opt = Adam(cfg, [self.p[n] for n in self.disc_names])

    def step(self, cond, mask, real, noise, spans, cond_spans):
        """One critic and one generator update; returns (d_loss, g_loss)."""
        c = self.cfg
        nb, nh = len(c["gen_hidden"]), len(c["disc_hidden"])
        pac, tau, p_drop = c["pac"], c["tau"], c["dropout"]
        d_params = [self.p[n] for n in self.disc_names]
        with torch.no_grad():
            fake = activations(generator(self.p, noise["z_d"], cond, nb),
                               spans, noise["u_d"], tau)
        fake_in = torch.cat([fake, cond], dim=1)
        real_in = torch.cat([real, cond], dim=1)
        with torch.enable_grad():
            for t in d_params:
                t.requires_grad_(True)
            y_fake = critic(self.p, fake_in, pac, nh, p_drop,
                            noise["keep_d_fake"])
            y_real = critic(self.p, real_in, pac, nh, p_drop,
                            noise["keep_d_real"])
            gp = gradient_penalty(self.p, real_in, fake_in, noise["gp_eps"],
                                  pac, nh)
            d_loss = (torch.mean(y_fake) - torch.mean(y_real)
                      + c["gp_lambda"] * gp)
            d_grads = torch.autograd.grad(d_loss, d_params)
            for t in d_params:
                t.requires_grad_(False)
        self.d_opt.update(d_params, d_grads)

        g_params = [self.p[n] for n in self.gen_names]
        with torch.enable_grad():
            for t in g_params:
                t.requires_grad_(True)
            logits = generator(self.p, noise["z_g"], cond, nb)
            fake = activations(logits, spans, noise["u_g"], tau)
            y_fake = critic(self.p, torch.cat([fake, cond], dim=1), pac, nh,
                            p_drop, noise["keep_g"])
            g_loss = (-torch.mean(y_fake)
                      + conditional_loss(logits, cond, mask, cond_spans))
            g_grads = torch.autograd.grad(g_loss, g_params)
            for t in g_params:
                t.requires_grad_(False)
        self.g_opt.update(g_params, g_grads)
        return float(d_loss), float(g_loss)

    def flat(self, layout) -> torch.Tensor:
        return torch.cat([self.p[n].reshape(-1) for n, *_ in layout])

    def load(self, flat: torch.Tensor, layout) -> None:
        for k, t in unflatten(flat, layout).items():
            self.p[k].copy_(t)

    def first_moments(self) -> dict:
        return {**dict(zip(self.gen_names, self.g_opt.m)),
                **dict(zip(self.disc_names, self.d_opt.m))}


def merge(clients: list[Client], w: torch.Tensor, layout) -> torch.Tensor:
    """The federator's weighted average of every client's parameters,
    copied back to every client."""
    w = w.float() / torch.clamp(torch.sum(w.float()), min=1e-12)
    merged = torch.sum(torch.stack([c.flat(layout) for c in clients])
                       * w[:, None], dim=0)
    for c in clients:
        c.load(merged, layout)
    return merged
