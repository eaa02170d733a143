"""The language model, its train step and its serving path, the port's
copy of the JAX package's ``models/model.py``.

``embed -> n_rep x pattern -> norm -> head``: ``pattern`` is a short tuple
of block kinds (``attn``, ``xattn``, ``mamba``, ``mlstm``, ``slstm``),
each block followed by a dense SwiGLU or a mixture-of-experts FFN
(``cfg.ffn_is_moe(pos)``) when ``d_ff > 0``.  Inputs are token ids, or,
with ``embed_inputs=False`` (hubert), frame embeddings ``features`` (B, S,
D) projected by ``in_proj``; cross-attention blocks read ``vision`` (B,
n, D), the frontend's embeddings.  Parameters are a nested dict of
tensors, keyed as the reference's tree: ``embed``, ``in_proj`` (frame
inputs only), ``final_norm``, ``lm_head`` (untied only) and ``layers``, a
list with one ``{"pos0": {...}, "pos1": {...}}`` per repetition of the
pattern where the reference stacks each leaf over a leading ``n_rep``
axis.  A cross-attention block keeps its projections under ``attn`` and
a float32 scalar ``xattn_gate`` (0 at init, so ``tanh`` switches it off
until trained).  Decode caches mirror ``layers``: a list of ``{"pos<i>":
KVCache | MambaState | MLSTMState | SLSTMState | (B,) int32}``, the last a
cross-attention block's placeholder (its keys and values are recomputed
from ``vision`` at every step).  With ``cfg.remat`` each repetition runs
under ``torch.utils.checkpoint`` (non-reentrant), the reference's
``jax.checkpoint`` of the scanned body: the backward recomputes the
forward, so a flash-attention forward launches twice per layer and
training step.  With :class:`ShardHints` over DTensor parameters, the
residual stream, attention's K and V, the MoE dispatch and the logits are
redistributed to the reference's sharding constraints; on plain tensors
the hints change nothing.  ``init(device="meta")`` gives the parameters'
shapes and dtypes without values, for the launch tooling's dry runs.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Iterator, NamedTuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device, seeded_generator
from . import attention as attn
from . import ssm
from .config import ModelConfig
from .layers import PartitionSpec, dense_init, rms_norm, spec_placements
from .moe import dense_ffn, init_dense_ffn, init_moe, moe_ffn


def _is_node(tree) -> bool:
    return (isinstance(tree, (list, tuple))
            and not isinstance(tree, PartitionSpec))


def tree_items(tree, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """``(path, leaf)`` pairs of a nested dict/list/tuple of tensors (a
    :class:`PartitionSpec` is a leaf), dict keys in sorted order (as
    ``jax.tree`` flattens a dict), paths joined by ``/``
    (``layers/0/pos0/attn/wq``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    elif _is_node(tree):
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
        if isinstance(t, list):
            return [build(x) for x in t]
        if _is_node(t):                 # a tuple or a NamedTuple
            items = [build(x) for x in t]
            return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
        return next(it)
    return build(like)


@dataclasses.dataclass(frozen=True)
class ShardHints:
    """Activation sharding constraints: ``dp`` the batch axes, ``tp`` the
    tensor axis, ``residual`` the carry's sharding between blocks,
    ``"dmodel"`` (batch x d_model) or ``"seq"`` (Megatron sequence
    sharding, kept for A/B runs).  ``reshards`` counts the layouts
    :meth:`regroup` changed, by what it changed them for."""
    dp: tuple[str, ...] = ("data",)
    tp: str | None = "model"
    residual: str = "dmodel"
    reshards: collections.Counter = dataclasses.field(
        default_factory=collections.Counter, compare=False, hash=False)

    def constrain(self, x, spec):
        """A DTensor redistributed to ``spec``'s placements on its mesh;
        any other tensor unchanged (as the reference's constraint is a
        no-op off a mesh)."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(x.device_mesh,
                              spec_placements(spec, x.device_mesh))

    def regroup(self, x, like, dims: dict, what: str):
        """A DTensor ``x`` laid out on its mesh as ``like`` (a DTensor on
        the same mesh) is: where ``like`` is sharded on its dim ``d``, ``x``
        is sharded on its dim ``dims[d]``, and replicated where ``dims``
        names none (partial sums are reduced).  Counted in
        ``reshards[what]`` when it moves ``x``; any other tensor is
        returned unchanged."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(x, DTensor):
            return x
        want = [Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                else Replicate() for p in like.placements]
        if list(x.placements) == want:
            return x
        self.reshards[what] += 1
        return x.redistribute(x.device_mesh, want)


# factories that take a device: on the meta device they drop their
# generator (torch has no meta generator)
_FACTORIES = (torch.randn, torch.rand, torch.zeros, torch.ones, torch.full,
              torch.empty, torch.arange)


class _OnMeta(TorchFunctionMode):
    """Every factory call made on the meta device: shapes and dtypes,
    no values, no allocation."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _FACTORIES:
            kwargs.pop("generator", None)
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


class Transformer:
    """The language model of every block kind and input kind of the
    reference."""

    def __init__(self, cfg: ModelConfig, shard: ShardHints | None = None):
        self.cfg = cfg
        self.shard = shard
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def init(self, *, seed: int = 0,
             device: torch.device | str = "cuda") -> dict:
        """Random parameters drawn on ``device`` from ``seed``, every leaf
        a tensor that requires grad.  The draws are not the reference's:
        carry its parameters across with
        :func:`repro_torch.interop.lm_params_from_reference`.  On
        ``device="meta"`` the leaves have shapes and dtypes and no values.
        An unknown block kind raises ``ValueError``."""
        if torch.device(device).type == "meta":
            with _OnMeta():
                return self.init(seed=seed, device="cpu")
        cfg, dtype = self.cfg, self.dtype
        dev = resolve_device(device)
        g = seeded_generator(dev, seed)
        D = cfg.d_model
        params: dict = {}
        if not cfg.embed_inputs:
            params["in_proj"] = dense_init(g, D, D, dtype)
        # the token table, or with frame inputs the output classes' table
        params["embed"] = (torch.randn((cfg.vocab, D), generator=g,
                                       device=dev) * 0.02).to(dtype)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(g, D, cfg.vocab, dtype)
        params["final_norm"] = torch.ones((D,), device=dev)
        layers = []
        for _ in range(cfg.n_rep):
            rep = {}
            for pos, kind in enumerate(cfg.pattern):
                blk = {"pre_norm": torch.ones((D,), device=dev)}
                if kind == "attn":
                    blk["attn"] = attn.init_attention(g, cfg, dtype)
                elif kind == "xattn":
                    blk["attn"] = attn.init_attention(g, cfg, dtype,
                                                      cross=True)
                    blk["xattn_gate"] = torch.zeros((), device=dev)
                elif kind == "mamba":
                    blk["mamba"] = ssm.init_mamba(g, cfg, dtype)
                elif kind == "mlstm":
                    blk["mlstm"] = ssm.init_mlstm(g, cfg, dtype)
                elif kind == "slstm":
                    blk["slstm"] = ssm.init_slstm(g, cfg, dtype)
                else:
                    raise ValueError(kind)
                if cfg.d_ff > 0:
                    blk["ffn_norm"] = torch.ones((D,), device=dev)
                    if cfg.ffn_is_moe(pos):
                        blk["moe"] = init_moe(g, cfg, dtype)
                    else:
                        blk["ffn"] = init_dense_ffn(g, cfg, dtype)
                rep[f"pos{pos}"] = blk
            layers.append(rep)
        params["layers"] = layers
        for t in tree_leaves(params):
            t.requires_grad_(True)
        return params

    # ------------------------------------------------------------------
    # full sequence
    # ------------------------------------------------------------------
    def _ffn(self, blk: dict, x: torch.Tensor, shard_moe: bool = True
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The block's FFN on the residual x, and the MoE's aux loss (None
        for a dense FFN or none)."""
        if self.cfg.d_ff == 0:
            return x, None
        h = rms_norm(x, blk["ffn_norm"], self.cfg.norm_eps)
        if "moe" in blk:
            y, metrics = moe_ffn(blk["moe"], h, self.cfg,
                                 shard=self.shard if shard_moe else None)
            return x + y, metrics.aux_loss
        return x + dense_ffn(blk["ffn"], h), None

    def _cross(self, blk: dict, h: torch.Tensor,
               vision: torch.Tensor) -> torch.Tensor:
        y = attn.cross_attention_block(blk["attn"], h, vision, cfg=self.cfg)
        return y * torch.tanh(blk["xattn_gate"]).to(y.dtype)

    def _apply_rep(self, rep: dict, x: torch.Tensor, positions: torch.Tensor,
                   vision: torch.Tensor | None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """One repetition of the pattern over the full sequence; returns
        the residual and the repetition's summed MoE aux loss."""
        cfg = self.cfg
        aux = torch.zeros((), device=x.device)
        for pos, kind in enumerate(cfg.pattern):
            blk = rep[f"pos{pos}"]
            h = rms_norm(x, blk["pre_norm"], cfg.norm_eps)
            if kind == "attn":
                y = attn.attention_block(blk["attn"], h, cfg=cfg,
                                         positions=positions,
                                         shard=self.shard)
            elif kind == "xattn":
                y = self._cross(blk, h, vision)
            elif kind == "mamba":
                y = ssm.mamba_block(blk["mamba"], h, cfg)
            elif kind == "mlstm":
                y = ssm.mlstm_block(blk["mlstm"], h, cfg)
            else:
                y = ssm.slstm_block(blk["slstm"], h, cfg)
            x, a = self._ffn(blk, x + y)
            if a is not None:
                aux = aux + a
            x = self._constrain_residual(x)
        return x, aux

    def _constrain_residual(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream between blocks under ``shard``: batch x
        d_model (or x sequence), batch only at one position (decode)."""
        sh = self.shard
        if sh is None:
            return x
        if x.shape[1] > 1:
            spec = ((sh.dp, None, sh.tp) if sh.residual == "dmodel"
                    else (sh.dp, sh.tp, None))
            return sh.constrain(x, spec)
        return sh.constrain(x, (sh.dp, None, None))

    def _embed(self, params: dict, batch: dict) -> torch.Tensor:
        if self.cfg.embed_inputs:
            table, sh = params["embed"], self.shard
            if sh is not None:
                # gathered before the lookup: DTensor's lookup in a
                # vocab-sharded table leaves partial rows whose gradient
                # it cannot route back, and torch 2.11 has no strategy for
                # an index's backward (index_put)
                table = sh.constrain(table, (None, None))
            return F.embedding(batch["tokens"], table)
        return batch["features"].to(self.dtype) @ params["in_proj"]

    def _vision(self, batch: dict) -> torch.Tensor | None:
        vision = batch.get("vision")
        return None if vision is None else vision.to(self.dtype)

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        w = (params["embed"].t() if self.cfg.tie_embeddings
             else params["lm_head"])
        logits = x @ w
        sh = self.shard
        if sh is not None:
            spec = ((sh.dp, None, sh.tp) if logits.dim() == 3
                    else (sh.dp, sh.tp))
            logits = sh.constrain(logits, spec)
        return logits

    def forward(self, params: dict, batch: dict
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  ``batch``: ``tokens`` (B, S) or, with
        frame inputs, ``features`` (B, S, D); ``vision`` (B, n, D) for
        cross-attention.  Returns (logits (B, S, V), the MoE aux loss
        summed over the layers, 0 without experts)."""
        x = self._embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        vision = self._vision(batch)
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux = torch.zeros((), device=x.device)
        for rep in params["layers"]:
            if remat:
                x, a = checkpoint(self._apply_rep, rep, x, positions, vision,
                                  use_reentrant=False)
            else:
                x, a = self._apply_rep(rep, x, positions, vision)
            aux = aux + a
        return self._head(params, x), aux

    def loss(self, params: dict, batch: dict
             ) -> tuple[torch.Tensor, dict]:
        """Mean token cross-entropy in float32 (masked by
        ``batch["loss_mask"]`` where given) plus ``router_aux_weight``
        times the MoE aux loss."""
        logits, aux = self.forward(params, batch)
        lf = logits.float()
        logz = torch.logsumexp(lf, dim=-1)
        labels = batch["labels"].long()
        label_logit = torch.gather(lf, -1, labels[..., None])
        if self.shard is not None:
            # over vocab-sharded logits each rank gathers the labels it
            # holds: the partial values are summed over the model axis
            # (the reference's one-hot product sums them the same way)
            label_logit = self.shard.constrain(label_logit,
                                               (self.shard.dp, None, None))
        label_logit = label_logit[..., 0]
        nll = logz - label_logit
        mask = batch.get("loss_mask")
        if mask is None:
            ce = torch.mean(nll)
        else:
            ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        total = ce + self.cfg.router_aux_weight * aux
        return total, {"ce": ce, "moe_aux": aux}

    # ------------------------------------------------------------------
    # decode path
    # ------------------------------------------------------------------
    def init_caches(self, batch: int, seq_len: int, *,
                    device: torch.device | str = "cuda") -> list:
        """Empty caches, one ``{"pos<i>": ...}`` per repetition: KV caches
        of ``seq_len`` slots for attention, zero recurrent states for the
        Mamba, mLSTM and sLSTM blocks, a (batch,) int32 placeholder for
        cross-attention."""
        cfg, dev = self.cfg, resolve_device(device)
        make = {"attn": lambda: attn.init_kv_cache(cfg, batch, seq_len,
                                                   self.dtype, device=dev),
                "xattn": lambda: torch.zeros((batch,), dtype=torch.int32,
                                             device=dev),
                "mamba": lambda: ssm.init_mamba_state(cfg, batch, device=dev),
                "mlstm": lambda: ssm.init_mlstm_state(cfg, batch, device=dev),
                "slstm": lambda: ssm.init_slstm_state(cfg, batch, device=dev)}
        return [{f"pos{pos}": make[kind]() for pos, kind in
                 enumerate(cfg.pattern)} for _ in range(cfg.n_rep)]

    def prefill(self, params: dict, batch: dict, max_len: int
                ) -> tuple[torch.Tensor, list]:
        """One-pass prompt processing: the full-sequence forward that also
        returns decode-ready caches (KV rings, recurrent states).
        ``batch``: ``{"tokens": (B, S)}`` (or ``features``) and ``vision``
        for cross-attention; ``max_len`` sizes the KV caches.  Returns
        (last-position logits (B, V), caches)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        B = x.shape[0]
        positions = torch.arange(x.shape[1], device=x.device)
        vision = self._vision(batch)
        caches = []
        for rep in params["layers"]:
            new = {}
            for pos, kind in enumerate(cfg.pattern):
                blk = rep[f"pos{pos}"]
                h = rms_norm(x, blk["pre_norm"], cfg.norm_eps)
                if kind == "attn":
                    y, cache = attn.attention_prefill(
                        blk["attn"], h, cfg=cfg, positions=positions,
                        max_len=max_len)
                elif kind == "xattn":
                    y = self._cross(blk, h, vision)
                    cache = torch.zeros((B,), dtype=torch.int32,
                                        device=x.device)
                elif kind == "mamba":
                    y, cache = ssm.mamba_block(blk["mamba"], h, cfg,
                                               return_state=True)
                elif kind == "mlstm":
                    y, cache = ssm.mlstm_block(blk["mlstm"], h, cfg,
                                               return_state=True)
                else:
                    y, cache = ssm.slstm_block(blk["slstm"], h, cfg,
                                               return_state=True)
                x, _ = self._ffn(blk, x + y)
                new[f"pos{pos}"] = cache
            caches.append(new)
        return self._head(params, x[:, -1, :]), caches

    def decode_step(self, params: dict, caches: list, batch: dict
                    ) -> tuple[torch.Tensor, list]:
        """One-token decode.  ``batch``: ``{"token": (B, 1)}`` (or
        ``features`` (B, 1, D)) and ``vision`` for cross-attention.
        Returns (logits (B, V), the next caches)."""
        cfg = self.cfg
        x = (params["embed"][batch["token"]] if cfg.embed_inputs else
             batch["features"].to(self.dtype) @ params["in_proj"])
        vision = self._vision(batch)
        new_caches = []
        for rep, rep_caches in zip(params["layers"], caches, strict=True):
            new = {}
            for pos, kind in enumerate(cfg.pattern):
                blk, cache = rep[f"pos{pos}"], rep_caches[f"pos{pos}"]
                h = rms_norm(x, blk["pre_norm"], cfg.norm_eps)
                if kind == "attn":
                    y, cache = attn.attention_decode(blk["attn"], h, cache,
                                                     cfg=cfg,
                                                     shard=self.shard)
                elif kind == "xattn":
                    y = self._cross(blk, h, vision)
                elif kind == "mamba":
                    y, cache = ssm.mamba_decode(blk["mamba"], h, cache, cfg)
                elif kind == "mlstm":
                    y, cache = ssm.mlstm_decode(blk["mlstm"], h, cache, cfg)
                else:
                    y, cache = ssm.slstm_decode(blk["slstm"], h, cache, cfg)
                # the reference's decode gives its MoE no hints
                x, _ = self._ffn(blk, x + y, shard_moe=False)
                new[f"pos{pos}"] = cache
            new_caches.append(new)
        return self._head(params, x[:, -1, :]), new_caches


class TrainState(NamedTuple):
    params: dict
    opt_state: object
    step: int


def make_train_step(model: Transformer, optimizer):
    """One optimizer step on a batch: the loss's gradient w.r.t. every
    parameter (0 for one the loss does not read), then
    ``optimizer.update``, which writes the new values into the parameter
    tensors in place.  Returns (new state, metrics); the
    metrics are 0-dim tensors on the device (reading them waits for it)."""
    def train_step(state: TrainState, batch: dict):
        leaves = tree_leaves(state.params)
        with torch.enable_grad():
            loss, metrics = model.loss(state.params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss never reads (frame inputs' output-class table)
        # has gradient 0, as in the reference
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, leaves)]
        opt_state = optimizer.update(grads, state.opt_state, leaves)
        metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
        return TrainState(state.params, opt_state, state.step + 1), metrics
    return train_step


def make_serve_step(model: Transformer):
    """``(params, caches, batch) -> (logits, caches)``: one decode step."""
    def serve_step(params: dict, caches: list, batch: dict):
        return model.decode_step(params, caches, batch)
    return serve_step
