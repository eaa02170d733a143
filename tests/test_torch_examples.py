"""The five examples' twins on the PyTorch port (``examples/*_torch.py``)
run on the CPU and print their references' headline lines.

Each twin's ``main(argv)`` runs in this process with ``--device cpu`` and
the smallest sizes its flags allow (the defaults are the references' and
run on the card, ``chip_smoke.py`` phase 22).  The launches of each run
are held to the counts ``torch_examples.launches`` derives from its
settings, the derivation phase 22 gates the card's runs with, on the plain
route.  What the quickstart and privacy_attack print that follows no draw
(the partitions, the §4.1 marginals and moments, the DP epsilon) is held
to the reference's functions on the same seed.  A fresh interpreter that loads
all five shows neither jax nor the JAX package in ``sys.modules``; and
without a card each twin's default device refuses to run rather than
falling back to the CPU.  ``malicious_client_ablation_torch`` runs in
``tests/test_torch_examples_ablation.py``, a file of its own so that the
suite's workers can take the two files apart.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.kernels import ops  # noqa: E402
from torch_examples import (EXAMPLES, ROOT, TWINS, load,  # noqa: E402
                            run_on_cpu)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (twin, its flags, lines its output must hold); the launches come from
# ``torch_examples.launches``
RUNS = {
    "quickstart": (
        "quickstart_torch",
        ["--rows", "300", "--rounds", "2"],
        ["dataset: adult, 300 rows, 14 columns",
         "aggregation weights (§4.2):",
         "-> the 300-row client dominates, as the paper predicts",
         "round   2: avg_jsd=", "bytes on wire per round (federator NIC):",
         "5 synthetic rows (decoded through the fused kernel):"]),
    "serve_lm": (
        "serve_batched_torch", [],
        ["serving smollm-135m-smoke: batch=4 prompt=16 gen=12", "prefill ",
         "tok/s)", "request 0: [", "request 1: ["]),
    "serve_lm_xlstm": (
        "serve_batched_torch", ["--arch", "xlstm-1.3b"],
        ["serving xlstm-1.3b-smoke: batch=4 prompt=16 gen=12",
         "request 0:"]),
    "serve_tabular": (
        "serve_batched_torch",
        ["--tabular", "--rounds", "1", "--requests", "3", "--sizes",
         "20,50"],
        ["warm-up: 1 federated rounds on adult (1500 rows, 14 cols)",
         "warmup: ran 1 programs for buckets (64,)",
         "served 3 requests / 90 rows", "0 serving compiles"]),
    "federated_llm_pretrain": (
        "federated_llm_pretrain_torch", ["--rounds", "2", "--seq", "16"],
        ["model: smollm-135m-smoke (", "similarity weights over Non-IID "
         "clients:", "loss: "]),
    "privacy_attack": (
        "privacy_attack_torch", ["--rounds", "1", "--local-steps", "2"],
        ["1 rounds x 2 local steps",
         "--- §4.1 setup leakage (transmitted exactly, by design) ---",
         "attack AUC ", "(null calibration", "probe hit rate",
         "DP moved the attack toward chance",
         "(§4.1 setup marginals are unchanged by DP — by design)"]),
}
# privacy_attack's return: 0 when DP moved the attack toward chance.  At
# these flags the CPU's draws give 0.658 -> 0.510; the reference's own
# draws give 0.498 -> 0.463 and its WARNING (return 1).  Which way the
# AUC moves follows the draws, which the packages do not share; the DP
# step is held to the reference with injected noise in test_torch_dp.py.
RETURNS = {"privacy_attack": (0,)}


def _quickstart_matches_reference(out, argv):
    """The deterministic part of the quickstart: the reference's partition
    of the same table.  (The §4.2 weights follow the VGM fits' draws.)"""
    from repro.tabular import make_dataset, partition_quantity_skew

    rows = int(argv[argv.index("--rows") + 1])
    parts = partition_quantity_skew(make_dataset("adult", n_rows=rows,
                                                 seed=0),
                                    n_clients=3, small_rows=250)
    assert f"client rows: {[len(p) for p in parts]}" in out, out


def _privacy_matches_reference(out, argv):
    """What the wire leaks before training, by the reference's functions
    on the same seed: the victim's shards, the first categorical column's
    per-client marginals (``federated_encoder_init``), the first
    continuous column's per-client moments (``fit_vgm`` with
    ``setup_federation``'s keys, ``vgm_client_moments``), and the DP run's
    epsilon."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.core.encoding import (compute_client_stats,
                                     federated_encoder_init)
    from repro.gan.dp import DPConfig
    from repro.privacy import RoundTrace, vgm_client_moments
    from repro.tabular import make_dataset, partition_label_skew
    from repro.tabular.vgm import fit_vgm

    twin = load("privacy_attack_torch")
    args = twin.parse(argv)
    ds = make_dataset("adult", n_rows=args.rows, seed=args.seed)
    parts = partition_label_skew(ds, 2, alpha=0.3, seed=args.seed)
    assert (f"victim: 2 clients x {[p.shape[0] for p in parts]} rows"
            in out), out
    kinds = [c.kind for c in ds.schema]
    j = kinds.index("categorical")
    stats = [compute_client_stats(p[:, [j]], [ds.schema[j]],
                                  jax.random.PRNGKey(0)) for p in parts]
    init = federated_encoder_init(stats, [ds.schema[j]],
                                  jax.random.PRNGKey(0))
    marg = np.stack([cf[0] for cf in init.client_cat_freqs])
    assert f"column {j} per-client marginals:\n{marg.round(3)}" in out, out
    c = kinds.index("continuous")
    k_stats = jax.random.split(jax.random.PRNGKey(args.seed), 5)[0]
    tr = RoundTrace()
    fits = [fit_vgm(jnp.asarray(p[:, c], jnp.float32),
                    jax.random.split(jax.random.fold_in(k_stats, i),
                                     len(ds.schema))[c],
                    max_modes=ds.schema[c].max_modes)
            for i, p in enumerate(parts)]
    for field, attr in (("vgm_means", "means"), ("vgm_stds", "stds"),
                        ("vgm_weights", "weights")):
        getattr(tr, field)[c] = np.stack([np.asarray(getattr(f, attr))
                                          for f in fits])
    mom = vgm_client_moments(tr, c)
    assert (f"column {c} per-client mean/std: {mom['mean'].round(3)} / "
            f"{mom['std'].round(3)}") in out, out
    eps = DPConfig(noise_mult=args.noise).epsilon(
        args.rounds * args.local_steps, twin.CFG.batch_size,
        min(p.shape[0] for p in parts))
    assert f"at eps ~= {eps:.3g}" in out, out


REFERENCE_CHECKS = {"quickstart": _quickstart_matches_reference,
                    "privacy_attack": _privacy_matches_reference}


@pytest.mark.parametrize("case", list(RUNS))
def test_twin_runs_on_the_cpu(case, capsys):
    name, argv, lines = RUNS[case]
    out = run_on_cpu(name, argv, lines, capsys,
                     returns=RETURNS.get(case, (None,)))
    if case in REFERENCE_CHECKS:
        REFERENCE_CHECKS[case](out, argv)


def test_llm_pretrain_keeps_its_loss_falls_assert():
    """The twin keeps its reference's "loss falls" assert; a run whose last
    round does not beat its first must fail it."""
    module = load("federated_llm_pretrain_torch")
    with pytest.raises(AssertionError, match="make progress"):
        module.run_federated = lambda *a, **k: (None, [{"loss": 1.0},
                                                       {"loss": 2.0}],
                                                torch.ones(4).numpy())
        module.main(["--rounds", "2", "--seq", "16", "--device", "cpu"])


def test_twins_import_neither_jax_nor_the_reference():
    code = (
        "import importlib.util, sys\n"
        f"for name in {list(TWINS)!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'examples/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.core.architectures' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT),
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    for name in TWINS:
        text = (EXAMPLES / f"{name}.py").read_text()
        for word in ("import jax", "from jax", "from repro.",
                     "import repro\n"):
            assert word not in text, (name, word)


@pytest.mark.parametrize("name", TWINS)
def test_twin_defaults_to_the_card_and_does_not_fall_back(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with ops.dispatch_scope() as counts:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(name).main([])
    assert not counts
