"""Serving entry points on the card: LM prefill + decode, and streaming
tabular synthesis.

LM mode (batched one-pass prefill, then token-by-token decode):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
      --batch 4 --prompt-len 2048 --gen 32 [--smoke] [--device cpu]

the counterpart of the JAX package's ``prefill_and_decode``
(``launch/serve.py``).  Prompts, weights and the stubbed vision
frontend's embeddings (llama-3.2-vision) are random from ``--seed``;
xLSTM's mLSTM layers run their prefill through the ``mlstm_chunk`` kernel.
Encoder-only hubert has no decode step and is refused.

Tabular mode:

  PYTHONPATH=src python -m repro_torch.launch.serve --tabular \
      --requests 16 --sizes 100,256,777 [--conditional] [--device cpu]

the counterpart of ``run_tabular_server``: a short Fed-TGAN run
(``run_federated``, 3 quantity-skewed clients of ``adult``) trains the
generator and fits the encoders, the table is registered with a ladder
fitted to the expected sizes, warmed up, and a mixed-size trace drains
through :class:`~repro_torch.serve.StreamingSynthesizer`.  ``make_tenant``
builds a servable table with a freshly initialized generator instead,
for serving runs that need no training.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import (ARCH_NAMES, ctgan_paper, get_config, get_smoke_config,
                       supported_shapes)
from ..core.architectures import run_federated
from ..device import resolve_device, seeded_generator
from ..gan.ctgan import CTGANConfig, Generator, init_generator
from ..models import ModelConfig, Transformer, make_serve_step
from ..models.attention import KVCache
from ..serve import StreamingSynthesizer, TableRegistry, ladder_from_sizes
from ..tabular import (TableEncoders, fit_centralized_encoders, make_dataset,
                       partition_quantity_skew)
from ..tabular.datasets import TabularDataset

# the reference's warm-up model (launch/serve.py, run_tabular_server)
WARMUP_CONFIG = CTGANConfig(batch_size=100, gen_hidden=(128, 128),
                            disc_hidden=(128, 128), pac=10, z_dim=64)


def make_tenant(name: str, *, n_rows: int | None = None,
                cfg: CTGANConfig = ctgan_paper.CONFIG, seed: int = 0,
                device: torch.device | str = "cuda"
                ) -> tuple[TabularDataset, TableEncoders, Generator,
                           torch.Tensor]:
    """One servable table on ``device``: the dataset, its encoders (VGMs
    fitted on the device), a generator initialized from ``seed``, and the
    table's encoded rows (one ``vgm_encode_table`` dispatch) from which
    registration derives the conditional-sampling marginals."""
    dev = resolve_device(device)
    ds = make_dataset(name, n_rows=n_rows, seed=seed)
    rng = torch.Generator(device=dev).manual_seed(seed)
    enc = fit_centralized_encoders(ds.data, ds.schema, generator=rng,
                                   device=dev)
    gen = init_generator(cfg, enc.cond_dim, enc.encoded_dim, generator=rng,
                         device=dev)
    encoded = enc.encode(ds.data, generator=rng)
    return ds, enc, gen, encoded


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prefill_and_decode(cfg: ModelConfig, *, batch: int, prompt_len: int,
                       gen_tokens: int, seed: int = 0,
                       temperature: float = 1.0, replay_prefill: bool = False,
                       device: torch.device | str = "cuda",
                       params: dict | None = None, prompts=None,
                       vision: torch.Tensor | None = None
                       ) -> tuple[np.ndarray, dict]:
    """One-pass prefill (``Transformer.prefill``), then token-by-token
    decode, without autograd.  The first decode input is the prefill's
    greedy token; each step then samples from ``softmax(logits /
    temperature)`` with a ``torch.Generator`` seeded from ``seed``, or
    takes the argmax at ``temperature=0``.  ``replay_prefill`` fills the
    caches through the decode path instead.  ``params`` and ``prompts``
    ((batch, prompt_len) token ids) replace the random weights and prompts
    drawn from ``seed``.  A model with cross-attention reads the stubbed
    vision frontend's embeddings (batch, xattn_tokens, d_model) at the
    prefill and at every decode step, as the reference's does: ``vision``,
    or standard normal draws from ``seed`` rounded to bfloat16.

    Returns the generated tokens (batch, gen_tokens) and stats:
    ``prefill_s``, ``decode_s``, ``tok_per_s`` (host clock, the card
    synchronized) and ``logits_finite`` (every logit of the prefill and
    of every step)."""
    dev = resolve_device(device)
    model = Transformer(cfg)
    serve = make_serve_step(model)
    max_len = prompt_len + gen_tokens
    with torch.no_grad():
        if params is None:
            params = model.init(seed=seed, device=dev)
        g = seeded_generator(dev, seed, 1)
        if prompts is None:
            prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                                    generator=g, device=dev)
        if not isinstance(prompts, torch.Tensor):
            prompts = torch.from_numpy(np.array(prompts, dtype=np.int64))
        prompts = prompts.to(dev).long()
        extras = {}
        if cfg.xattn_tokens:
            if vision is None:
                vision = torch.randn((batch, cfg.xattn_tokens, cfg.d_model),
                                     generator=seeded_generator(dev, seed, 2),
                                     device=dev).to(torch.bfloat16)
            extras["vision"] = vision.to(dev)

        _sync(dev)
        t0 = time.perf_counter()
        if replay_prefill:
            caches = [{k: KVCache(c.k, c.v, torch.zeros_like(c.length))
                       if isinstance(c, KVCache) else c for k, c in rep.items()}
                      for rep in model.init_caches(batch, max_len, device=dev)]
            for t in range(prompt_len):
                logits, caches = serve(params, caches,
                                       {"token": prompts[:, t:t + 1],
                                        **extras})
        else:
            logits, caches = model.prefill(params,
                                           {"tokens": prompts, **extras},
                                           max_len)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        finite = torch.isfinite(logits).all()
        tok = torch.argmax(logits, dim=-1)[:, None]
        out = []
        t0 = time.perf_counter()
        for _ in range(gen_tokens):
            logits, caches = serve(params, caches, {"token": tok, **extras})
            finite &= torch.isfinite(logits).all()
            if temperature > 0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=g)
            else:
                tok = torch.argmax(logits, dim=-1)[:, None]
            out.append(tok[:, 0])
        gen = (torch.stack(out, dim=1) if out else
               torch.zeros((batch, 0), dtype=torch.long, device=dev))
        gen = gen.cpu().numpy()
        t_decode = time.perf_counter() - t0
    return gen, {"prefill_s": t_prefill, "decode_s": t_decode,
                 "tok_per_s": batch * gen_tokens / max(t_decode, 1e-9),
                 "logits_finite": bool(finite)}


def run_tabular_server(*, requests: int = 16,
                       sizes: tuple[int, ...] = (100, 256, 777),
                       rounds: int = 4, local_steps: int = 2,
                       n_rows: int = 1500, conditional: bool = False,
                       scheduler: str = "fifo", seed: int = 0,
                       cfg: CTGANConfig = WARMUP_CONFIG,
                       device: torch.device | str = "cuda",
                       quiet: bool = False) -> dict:
    """Warm up a generator federatedly (``rounds`` x ``local_steps`` on
    ``adult`` with ``n_rows`` rows over 3 quantity-skewed clients), register
    it, warm up the server, and serve a trace of ``requests`` requests
    cycling through ``sizes``.  Returns the server stats plus throughput
    fields."""
    def say(msg):
        if not quiet:
            print(msg)

    dev = resolve_device(device)
    ds = make_dataset("adult", n_rows=n_rows, seed=seed)
    parts = partition_quantity_skew(ds, 3, small_rows=200)
    say(f"warm-up: {rounds} federated rounds on {ds.name} ({ds.n_rows} rows,"
        f" {len(ds.schema)} cols) on {dev}")
    res = run_federated(parts, ds.schema, cfg=cfg, rounds=rounds,
                        local_steps=local_steps, seed=seed, device=dev)
    enc, gen = res.encoders, res.final_g_params
    encoded = enc.encode(ds.data, generator=seeded_generator(dev, seed, 7))
    registry = TableRegistry()
    registry.register(ds.name, cfg, enc, gen, ladder=ladder_from_sizes(sizes),
                      encoded=encoded, device=dev)
    server = StreamingSynthesizer(registry, scheduler=scheduler, device=dev)
    built = server.warmup(conditional=conditional)
    ladder = registry.get(ds.name).ladder.buckets
    say(f"warmup: ran {built} programs for buckets {ladder} on {dev}")

    for r in range(requests):
        server.submit(ds.name, sizes[r % len(sizes)], seed=seed * 1000 + r,
                      conditional=conditional)
    t0 = time.perf_counter()
    responses = server.serve()
    dt = time.perf_counter() - t0

    stats = server.stats()
    rows = sum(r.rows for r in responses)
    if not all(np.isfinite(r.data).all() for r in responses):
        raise RuntimeError("a response holds non-finite values")
    stats.update(seconds=dt, rows_per_s=rows / max(dt, 1e-9),
                 buckets=list(ladder))
    say(f"served {len(responses)} requests / {rows} rows in {dt:.3f}s "
        f"({stats['rows_per_s']:.0f} rows/s) on {dev}: "
        f"{stats['serving_compiles']} serving compiles, "
        f"{stats['cache_hits']}/{len(responses)} warm, "
        f"decode dispatches {stats['decode_dispatches']}")
    return stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tabular", action="store_true",
                    help="serve streaming tabular synthesis instead of an LM")
    ap.add_argument("--requests", type=int, default=16,
                    help="[tabular] trace length")
    ap.add_argument("--sizes", default="100,256,777",
                    help="[tabular] comma list of request row counts, cycled")
    ap.add_argument("--rows", type=int, default=1500,
                    help="[tabular] rows of the registered table")
    ap.add_argument("--rounds", type=int, default=4,
                    help="[tabular] federated warm-up rounds")
    ap.add_argument("--conditional", action="store_true",
                    help="[tabular] draw condition vectors from the table's "
                         "marginals")
    ap.add_argument("--scheduler", choices=("fifo", "continuous"),
                    default="fifo", help="[tabular] queue drain")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.tabular:
        run_tabular_server(requests=args.requests,
                           sizes=tuple(int(s) for s in args.sizes.split(",")),
                           rounds=args.rounds, n_rows=args.rows,
                           conditional=args.conditional,
                           scheduler=args.scheduler, seed=args.seed,
                           device=args.device)
        return

    if "decode_32k" not in supported_shapes(args.arch):
        raise SystemExit(f"{args.arch} is encoder-only: no decode step")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen, stats = prefill_and_decode(cfg, batch=args.batch,
                                    prompt_len=args.prompt_len,
                                    gen_tokens=args.gen, seed=args.seed,
                                    device=args.device)
    print(f"generated {gen.shape} tokens | prefill {stats['prefill_s']:.2f}s "
          f"decode {stats['decode_s']:.2f}s ({stats['tok_per_s']:.1f} tok/s)"
          f" | logits finite {stats['logits_finite']}")
    print("sample:", gen[0][:16])


if __name__ == "__main__":
    main()
