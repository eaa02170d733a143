"""End-to-end serving on the PyTorch port: batched LLM decode, or
streaming tabular synthesis through ``repro_torch.serve``, on the card.

The twin of ``examples/serve_batched.py``.  Default mode serves a small
language model with batched requests through the decode path (KV caches,
GQA decode, per-arch block stacks; ``--arch xlstm-1.3b`` prefills its
mLSTM layers through the chunkwise mLSTM kernel).

``--tabular`` switches to the paper's own serving workload: a short
federated warm-up trains a CTGAN (sampler-in-the-loop rounds via
``repro_torch.synth.RoundEngine``), the table is registered with the
streaming server (``repro_torch.serve.StreamingSynthesizer``), and a
mixed-size request trace drains through the bucketed pipeline: one fused
``vgm_decode_table`` kernel launch per request and zero serving compiles
after warmup.

Run:
  PYTHONPATH=src python examples/serve_batched_torch.py [--arch smollm-135m]
      [--batch 4] [--prompt-len 16] [--gen 12]
  PYTHONPATH=src python examples/serve_batched_torch.py --tabular
      [--requests 16] [--sizes 100,256,777] [--rounds 4] [--conditional]

Flags accepted with ``--tabular``:
  --requests N      trace length (default 16)
  --sizes A,B,...   request row counts, cycled over the trace
                    (default 100,256,777; the bucket ladder is fitted to
                    this set, so any mix serves without recompiles)
  --rounds R        federated warm-up rounds before serving (default 4)
  --conditional     draw each request's condition vectors from the
                    table's training-by-sampling marginals instead of
                    zeroing them (CTGAN's real sampling mode)
  --scheduler S     fifo (default) or continuous: deficit-round-robin
                    dispatch cycles (identical responses on this
                    single-tenant trace)
The LLM flags (--arch/--batch/--prompt-len/--gen) are ignored in
``--tabular`` mode, and vice versa.  ``--device cpu`` runs the kernels'
plain PyTorch versions on a machine without a card.
"""
import argparse
import sys
sys.path.insert(0, "src")

from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import prefill_and_decode, run_tabular_server


def parse(argv=None) -> argparse.Namespace:
    """The settings of a run: the reference's flags and defaults, and
    ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_NAMES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--tabular", action="store_true",
                    help="serve streaming tabular synthesis requests "
                         "through the bucketed fused pipeline instead of "
                         "an LLM")
    ap.add_argument("--requests", type=int, default=16,
                    help="[tabular] trace length")
    ap.add_argument("--sizes", default="100,256,777",
                    help="[tabular] comma list of request row counts, "
                         "cycled over the trace")
    ap.add_argument("--rounds", type=int, default=4,
                    help="[tabular] federated warm-up rounds")
    ap.add_argument("--conditional", action="store_true",
                    help="[tabular] condition vectors from the table's "
                         "sampler marginals")
    ap.add_argument("--scheduler", choices=("fifo", "continuous"),
                    default="fifo",
                    help="[tabular] fifo or continuous-batching drain")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    return args


def main(argv=None):
    args = parse(argv)
    dev = resolve_device(args.device)

    if args.tabular:
        run_tabular_server(
            requests=args.requests,
            sizes=tuple(int(s) for s in args.sizes.split(",")),
            rounds=args.rounds, conditional=args.conditional,
            scheduler=args.scheduler, device=dev)
        return

    cfg = get_smoke_config(args.arch)
    print(f"serving {cfg.name}: batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}")
    gen, stats = prefill_and_decode(cfg, batch=args.batch,
                                    prompt_len=args.prompt_len,
                                    gen_tokens=args.gen, device=dev)
    print(f"prefill {stats['prefill_s']:.2f}s | "
          f"decode {stats['decode_s']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s)")
    for i, row in enumerate(gen[:2]):
        print(f"request {i}: {row.tolist()}")


if __name__ == "__main__":
    main()
