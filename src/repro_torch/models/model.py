"""The language model and its train step, the port's copy of the JAX
package's ``models/model.py`` for dense attention stacks.

``embed -> n_layers x (attention block + SwiGLU FFN) -> norm -> head``.
Parameters are a nested dict of tensors, keyed as the reference's tree:
``embed``, ``final_norm``, ``lm_head`` (untied only) and ``layers``, a
list with one ``{"pos0": {"pre_norm", "attn": {...}, "ffn_norm",
"ffn": {...}}}`` per layer where the reference stacks each leaf over a
leading ``n_rep`` axis.  With ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` (non-reentrant), the reference's
``jax.checkpoint`` of the scanned body: the backward recomputes the
layer's forward, so a flash-attention forward launches twice per layer
and training step.  The reference's ``ShardHints`` are TPU-mesh tooling
and are not ported.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device, seeded_generator
from . import attention as attn
from .config import ModelConfig
from .layers import dense_init, rms_norm
from .moe import dense_ffn, init_dense_ffn


def tree_items(tree, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """``(path, leaf)`` pairs of a nested dict/list of tensors, dict keys
    in sorted order (as ``jax.tree`` flattens a dict), paths joined by
    ``/`` (``layers/0/pos0/attn/wq``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_items(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree) -> list[torch.Tensor]:
    return [t for _, t in tree_items(tree)]


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` (a sequence in the
    order of :func:`tree_leaves`)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(x) for x in t]
        return next(it)
    return build(like)


class Transformer:
    """A dense attention-only language model.  Configs that need a piece
    the port does not have yet raise ``NotImplementedError`` naming it."""

    def __init__(self, cfg: ModelConfig):
        missing = []
        if tuple(cfg.pattern) != ("attn",):
            missing.append(f"blocks {cfg.pattern} other than ('attn',) "
                           "(models/ssm.py, cross-attention)")
        if cfg.n_experts > 0:
            missing.append("the mixture-of-experts FFN (models/moe.py)")
        if cfg.xattn_tokens:
            missing.append("cross-attention (models/attention.py)")
        if not cfg.embed_inputs:
            missing.append("frame-embedding inputs (embed_inputs=False)")
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: the port does not have " + "; ".join(missing)
                + " yet (ROADMAP)")
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def init(self, *, seed: int = 0,
             device: torch.device | str = "cuda") -> dict:
        """Random parameters drawn on ``device`` from ``seed``, every leaf
        a tensor that requires grad.  The draws are not the reference's:
        carry its parameters across with
        :func:`repro_torch.interop.lm_params_from_reference`."""
        cfg, dtype = self.cfg, self.dtype
        dev = resolve_device(device)
        g = seeded_generator(dev, seed)
        D = cfg.d_model
        params: dict = {
            "embed": (torch.randn((cfg.vocab, D), generator=g, device=dev)
                      * 0.02).to(dtype)}
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(g, D, cfg.vocab, dtype)
        params["final_norm"] = torch.ones((D,), device=dev)
        layers = []
        for _ in range(cfg.n_rep):
            blk = {"pre_norm": torch.ones((D,), device=dev),
                   "attn": attn.init_attention(g, cfg, dtype)}
            if cfg.d_ff > 0:
                blk["ffn_norm"] = torch.ones((D,), device=dev)
                blk["ffn"] = init_dense_ffn(g, cfg, dtype)
            layers.append({"pos0": blk})
        params["layers"] = layers
        for t in tree_leaves(params):
            t.requires_grad_(True)
        return params

    def _apply_block(self, blk: dict, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = rms_norm(x, blk["pre_norm"], cfg.norm_eps)
        x = x + attn.attention_block(blk["attn"], h, cfg=cfg,
                                     positions=positions)
        if cfg.d_ff > 0:
            h = rms_norm(x, blk["ffn_norm"], cfg.norm_eps)
            x = x + dense_ffn(blk["ffn"], h)
        return x

    def _embed(self, params: dict, batch: dict) -> torch.Tensor:
        return params["embed"][batch["tokens"]]

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        w = (params["embed"].t() if self.cfg.tie_embeddings
             else params["lm_head"])
        return x @ w

    def forward(self, params: dict, batch: dict
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  Returns (logits (B, S, V), moe_aux),
        the aux loss 0 without experts."""
        x = self._embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in params["layers"]:
            if remat:
                x = checkpoint(self._apply_block, layer["pos0"], x,
                               positions, use_reentrant=False)
            else:
                x = self._apply_block(layer["pos0"], x, positions)
        return self._head(params, x), torch.zeros((), device=x.device)

    def loss(self, params: dict, batch: dict
             ) -> tuple[torch.Tensor, dict]:
        """Mean token cross-entropy in float32 (masked by
        ``batch["loss_mask"]`` where given) plus the router aux term."""
        logits, aux = self.forward(params, batch)
        lf = logits.float()
        logz = torch.logsumexp(lf, dim=-1)
        labels = batch["labels"].long()
        label_logit = torch.gather(lf, -1, labels[..., None])[..., 0]
        nll = logz - label_logit
        mask = batch.get("loss_mask")
        if mask is None:
            ce = torch.mean(nll)
        else:
            ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        total = ce + self.cfg.router_aux_weight * aux
        return total, {"ce": ce, "moe_aux": aux}


class TrainState(NamedTuple):
    params: dict
    opt_state: object
    step: int


def make_train_step(model: Transformer, optimizer):
    """One optimizer step on a batch: the loss's gradient w.r.t. every
    parameter, then ``optimizer.update``, which writes the new values into
    the parameter tensors in place.  Returns (new state, metrics); the
    metrics are 0-dim tensors on the device (reading them waits for it)."""
    def train_step(state: TrainState, batch: dict):
        leaves = tree_leaves(state.params)
        with torch.enable_grad():
            loss, metrics = model.loss(state.params, batch)
            grads = torch.autograd.grad(loss, leaves)
        opt_state = optimizer.update(grads, state.opt_state, leaves)
        metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
        return TrainState(state.params, opt_state, state.step + 1), metrics
    return train_step
