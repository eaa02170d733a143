"""Language-model training entry points, the port's copy of the JAX
package's ``launch/train.py``.

Every block kind and input kind of ``Transformer`` trains, on the card
too: frame inputs (hubert) and cross-attention (llama-3.2-vision) take
the stubbed frontends' random embeddings (:func:`batch_maker`), and
xLSTM's mLSTM layers take their gradient from the chunkwise backward
kernel (``ops.mlstm_chunk`` under autograd), its sLSTM layers by
autograd through their time loop.  Two modes:

* ``--federated``: Fed-TGAN rounds over P simulated clients: the §4.2
  weights from token-frequency statistics, local Adam steps on every
  client, and the weighted merge of the parameters in one ``weighted_agg``
  launch per round (``--dp-noise``: client-level DP-FedAvg, each client's
  delta clipped and the merged delta noised, in the same launch);
* default: plain training on one stream (the "centralized" reference in
  federated terms).

The entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU, where the flash-attention, mLSTM and merge kernels run
as their plain PyTorch versions.  ``--smoke`` takes the reduced config of the CPU
tests::

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --steps 20 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --federated --clients 4 --rounds 5 --local-steps 2 \\
      --non-iid --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

from ..configs import ARCH_NAMES, get_config, get_smoke_config
from ..data.tokens import (TokenDatasetSpec, client_token_streams,
                           fed_weights_from_token_stats,
                           synthetic_token_batches, token_frequency_stats)
from ..device import resolve_device, seeded_generator
from ..fed.merge import (flatten_stacked, fused_weighted_merge, replicate,
                         unflatten_merged)
from ..gan.dp import DPConfig
from ..kernels import ops
from ..models import (TrainState, Transformer, make_train_step, tree_leaves,
                      tree_unflatten)
from ..optim import adam, cosine_schedule


# the seed stream of the stubbed frontends' frame and vision embeddings
FRONTEND_STREAM = 777


def _batch_dict(tokens: np.ndarray, device: torch.device) -> dict:
    """A token step's batch: the tokens are their own labels (no shift),
    as in the reference's LM rounds."""
    tk = torch.as_tensor(np.ascontiguousarray(tokens), device=device)
    return {"tokens": tk, "labels": tk}


def batch_maker(cfg, device: torch.device | str, seed: int = 0
                ) -> Callable[[np.ndarray], dict]:
    """``tokens (B, S) -> batch`` for ``cfg``'s inputs, the reference's
    ``_batch_dict``: the tokens are the labels; a model of frame inputs
    (``embed_inputs=False``, hubert) takes ``features`` (B, S, d_model)
    instead of tokens, and a model with cross-attention ``vision`` (B,
    xattn_tokens, d_model): the stubbed frontends' embeddings, standard
    normal draws in float32 rounded to bfloat16, from one generator
    seeded with (``seed``, ``FRONTEND_STREAM``) and drawn anew each
    step."""
    dev = resolve_device(device)
    g = seeded_generator(dev, seed, FRONTEND_STREAM)

    def stub(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def make(tokens: np.ndarray) -> dict:
        b = _batch_dict(tokens, dev)
        B, S = tokens.shape
        if not cfg.embed_inputs:
            b["features"] = stub(B, S, cfg.d_model)
            del b["tokens"]
        if cfg.xattn_tokens:
            b["vision"] = stub(B, cfg.xattn_tokens, cfg.d_model)
        return b
    return make


def run_centralized(cfg, *, steps, batch, seq, lr, seed=0, log_every=5,
                    device: torch.device | str = "cuda", init_params=None,
                    make_batch: Callable[[np.ndarray], dict] | None = None):
    """``steps`` Adam steps (b1 0.9, b2 0.95, global-norm clip 1.0, cosine
    schedule with warm-up ``max(steps // 10, 1)``) on one synthetic
    stream.  ``init_params`` (the port's parameter dict) replaces the
    seeded initialization, and ``make_batch`` (``tokens -> batch``) the
    stubbed frontends' draws of :func:`batch_maker`, so a test can start
    from the reference's parameters and feed its inputs.  Returns (state,
    history)."""
    dev = resolve_device(device)
    model = Transformer(cfg)
    opt = adam(cosine_schedule(lr, warmup=max(steps // 10, 1), total=steps),
               b1=0.9, b2=0.95, max_grad_norm=1.0)
    params = (model.init(seed=seed, device=dev) if init_params is None
              else init_params)
    state = TrainState(params, opt.init(tree_leaves(params)), 0)
    step_fn = make_train_step(model, opt)
    data = synthetic_token_batches(TokenDatasetSpec(cfg.vocab, seq), batch,
                                   steps, seed=seed)
    make_batch = make_batch or batch_maker(cfg, dev, seed)
    hist = []
    t0 = time.perf_counter()
    for s in range(steps):
        state, m = step_fn(state, make_batch(data[s]))
        if (s + 1) % log_every == 0 or s == steps - 1:
            loss = float(m["loss"])
            hist.append({"step": s + 1, "loss": loss,
                         "t": time.perf_counter() - t0})
            print(f"step {s + 1:5d} loss {loss:.4f} "
                  f"({(time.perf_counter() - t0) / (s + 1):.2f}s/step)")
    return state, hist


# the seed stream of the client-level DP noise, one generator per round
DP_STREAM = 555


def dp_merge(flat: torch.Tensor, start: torch.Tensor, weights: torch.Tensor,
             dp: DPConfig, noise: torch.Tensor) -> torch.Tensor:
    """DP-FedAvg's merge of the ``(P, D)`` float32 stack of the clients'
    parameters after local training (overwritten): each row's delta from
    the round's ``start`` (D,) clipped to global L2 norm ``dp.l2_clip``
    (``min(1, clip / sqrt(sum d^2 + 1e-12))``), the weighted mean of the
    clipped deltas in ONE ``weighted_agg`` launch, ``noise`` (D,) standard
    normal times ``dp.noise_mult * dp.l2_clip / P`` added, and the start
    added back.  Returns the merged (D,) parameters."""
    deltas = flat.sub_(start)
    gn = torch.sqrt(torch.sum(deltas * deltas, dim=1) + 1e-12)
    deltas.mul_(torch.clamp(dp.l2_clip / gn, max=1.0)[:, None])
    mean = ops.weighted_average_flat(deltas, weights)
    sigma = dp.noise_mult * dp.l2_clip / flat.shape[0]
    return start + (mean + sigma * noise)


def federated_round(states: list, step_fn, tokens, weights: torch.Tensor, *,
                    dp: DPConfig | None = None,
                    dp_noise: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    make_batch: Callable[[np.ndarray], dict] | None = None
                    ) -> torch.Tensor:
    """One global round in place: client i takes one step of ``step_fn``
    on each of its ``tokens[i]`` (local_steps, B, S) batches (made into a
    step's batch by ``make_batch``, default the token batch), then every
    client's parameters are replaced by the weighted merge (ONE
    ``weighted_agg`` launch).  With ``dp`` the merge is :func:`dp_merge`
    from client 0's parameters before the round (the broadcast model
    every client starts from); its (D,) noise is ``dp_noise`` or drawn
    from ``generator``.  Returns the (P, local_steps) losses, on the
    device."""
    dev = weights.device
    make_batch = make_batch or (lambda tk: _batch_dict(tk, dev))
    start = None
    if dp is not None:
        start = flatten_stacked([tree_leaves(states[0].params)])[0]
    losses = torch.empty((len(states), len(tokens[0])), device=dev)
    for i in range(len(states)):
        for e, tk in enumerate(tokens[i]):
            states[i], m = step_fn(states[i], make_batch(tk))
            losses[i, e] = m["loss"]
    trees = [tree_leaves(st.params) for st in states]
    if dp is None:
        replicate(fused_weighted_merge(trees, weights), trees)
        return losses
    if dp_noise is None:
        dp_noise = torch.randn(start.shape, generator=generator, device=dev)
    merged = dp_merge(flatten_stacked(trees), start, weights, dp, dp_noise)
    replicate(unflatten_merged(merged, trees[0]), trees)
    return losses


def lm_optimizer(lr):
    """The LM rounds' Adam: b1 0.9, b2 0.95, global-norm clip 1.0."""
    return adam(lr, b1=0.9, b2=0.95, max_grad_norm=1.0)


def run_federated(cfg, *, clients, rounds, local_steps, batch, seq, lr,
                  iid=True, seed=0, weighting="fedtgan", dp=None,
                  device: torch.device | str = "cuda", init_params=None,
                  on_round: Callable | None = None,
                  make_batch: Callable[[np.ndarray], dict] | None = None):
    """Fed-TGAN rounds on a language model: every client takes
    ``local_steps`` Adam steps (b1 0.9, b2 0.95, clip 1.0) on its own
    stream, then the parameters (not the moments: each client keeps its
    own Adam state) merge under the §4.2 weights in ONE ``weighted_agg``
    launch over the flattened float32 stack of all clients, and the merged
    values, rounded to each parameter's dtype, go to every client.

    ``dp`` (a :class:`~repro_torch.gan.dp.DPConfig`) switches the merge
    to DP-FedAvg (:func:`dp_merge`): client-level DP on the wire, the LM
    counterpart of the tabular per-pack DP-SGD; round r's noise is drawn
    from its own generator (seed, ``DP_STREAM``, r), and the spent
    (eps, delta) is printed at the end (every client takes part in every
    round: q = 1, one release a round).

    Clients run one after another on ``device``.  A model of frame or
    vision inputs draws them per step (:func:`batch_maker`); the client
    weights come from the token streams, which are the labels.
    ``init_params`` replaces the seeded initialization (a test hands in
    the reference's) and ``make_batch`` the frontends' draws;
    ``on_round(r, states, metrics)`` sees every round after its merge,
    ``metrics["loss"]`` a (P, local_steps) tensor.  Returns (states,
    history, weights)."""
    if weighting not in ("fedtgan", "uniform"):
        raise ValueError(f"weighting {weighting!r}: 'fedtgan' or 'uniform'")
    dev = resolve_device(device)
    model = Transformer(cfg)
    opt = lm_optimizer(lr)

    spec = TokenDatasetSpec(cfg.vocab, seq)
    streams = client_token_streams(spec, clients, batch,
                                   rounds * local_steps, iid=iid, seed=seed)
    # the paper's init protocol, token-adapted
    stats = [token_frequency_stats(s, cfg.vocab) for s in streams]
    n_tok = [int(s.size) for s in streams]
    if weighting == "fedtgan":
        w = fed_weights_from_token_stats(stats, n_tok)
    else:
        w = torch.full((clients,), 1.0 / clients)
    print(f"client weights: {w.numpy().round(4)}")
    w_dev = w.to(dev)

    params = (model.init(seed=seed, device=dev) if init_params is None
              else init_params)
    states = []
    for _ in range(clients):
        own = [t.detach().clone().requires_grad_(True)
               for t in tree_leaves(params)]
        states.append(TrainState(tree_unflatten(params, own), opt.init(own),
                                 0))
    step_fn = make_train_step(model, opt)
    make_batch = make_batch or batch_maker(cfg, dev, seed)

    hist = []
    t0 = time.perf_counter()
    for r in range(rounds):
        toks = [s[r * local_steps:(r + 1) * local_steps] for s in streams]
        losses = federated_round(
            states, step_fn, toks, w_dev, dp=dp, make_batch=make_batch,
            generator=None if dp is None else seeded_generator(
                dev, seed, DP_STREAM, r))
        loss = float(torch.mean(losses))
        hist.append({"round": r + 1, "loss": loss,
                     "t": time.perf_counter() - t0})
        print(f"round {r + 1:4d} mean-loss {loss:.4f}")
        if on_round is not None:
            on_round(r, states, {"loss": losses})
    if dp is not None:
        eps = dp.epsilon(rounds, clients, clients)
        print(f"client-level DP: clip {dp.l2_clip} noise {dp.noise_mult} "
              f"-> eps ~= {eps:.3g} (delta {dp.delta})")
    return states, hist, w.numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--federated", action="store_true")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--uniform-weights", action="store_true")
    ap.add_argument("--dp-noise", type=float, default=None,
                    help="client-level DP noise multiplier for the "
                         "federated merge (off when unset)")
    ap.add_argument("--dp-clip", type=float, default=1.0,
                    help="per-client update L2 clip for --dp-noise")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dp = (None if args.dp_noise is None else
          DPConfig(l2_clip=args.dp_clip, noise_mult=args.dp_noise))
    if args.federated:
        run_federated(cfg, clients=args.clients, rounds=args.rounds,
                      local_steps=args.local_steps, batch=args.batch,
                      seq=args.seq, lr=args.lr, iid=not args.non_iid,
                      weighting="uniform" if args.uniform_weights else "fedtgan",
                      dp=dp, device=args.device)
    else:       # as the reference, --dp-noise has no effect here
        run_centralized(cfg, steps=args.steps, batch=args.batch,
                        seq=args.seq, lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
