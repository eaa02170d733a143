"""The port's tabular layer held against the JAX package on the same data.

``make_dataset`` and the partitioners must give equal arrays.  ``fit_vgm``
gets the reference's jitter draw injected and must give close parameters
(rtol 1e-4, atol 1e-4 * std(x): 60 EM steps in float32, whose
reductions sum in another order in XLA and PyTorch) and equal ``valid``
masks.  Encode and decode run from the reference's own encoders (carried
over with ``encoders_from_reference``) and the reference's Gumbel draws:
one-hots and categorical columns must be equal, alphas and continuous
values close (rtol 1e-6, atol 1e-6: float32 rounding of the log-pdf,
and XLA's fused multiply-add in the decode).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.tabular import datasets as jds  # noqa: E402
from repro.tabular import encoders as jenc  # noqa: E402
from repro.tabular import vgm as jvgm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.tabular import datasets as tds  # noqa: E402
from repro_torch.tabular import encoders as tenc  # noqa: E402
from repro_torch.tabular import vgm as tvgm  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("name", ["adult", "covertype", "credit",
                                  "intrusion"])
def test_make_dataset_equals_reference(name):
    ours = tds.make_dataset(name, n_rows=257, seed=4)
    theirs = jds.make_dataset(name, n_rows=257, seed=4)
    np.testing.assert_array_equal(ours.data, theirs.data)
    assert [(c.name, c.kind) for c in ours.schema] == \
        [(c.name, c.kind) for c in theirs.schema]


@pytest.mark.parametrize("partition,kw", [
    ("partition_full_copy", {}), ("partition_iid", {"seed": 1}),
    ("partition_quantity_skew", {"small_rows": 50, "seed": 1}),
    ("partition_malicious", {"good_rows": 40, "bad_rows": 60, "seed": 1}),
    ("partition_label_skew", {"seed": 1}),
])
def test_partitioners_equal_reference(partition, kw):
    ours = getattr(tds, partition)(tds.make_dataset("adult", n_rows=300), 3,
                                   **kw)
    theirs = getattr(jds, partition)(jds.make_dataset("adult", n_rows=300),
                                     3, **kw)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def adult():
    """A small adult table, its reference encoders, and the same encoders
    carried over to the port (on the CPU)."""
    ds = jds.make_dataset("adult", n_rows=1024, seed=2)
    key = jax.random.PRNGKey(2)
    ref_enc = jenc.fit_centralized_encoders(ds.data, ds.schema, key)
    vgms = {j: {f: np.asarray(getattr(p, f))
                for f in ("weights", "means", "stds", "valid")}
            for j, p in ref_enc.vgms.items()}
    cats = {j: le.categories for j, le in ref_enc.label_encoders.items()}
    port_enc = interop.encoders_from_reference(ds.schema, vgms, cats,
                                               device="cpu")
    return ds, key, ref_enc, port_enc


def _close(a, b, x):
    scale = float(np.std(x))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-4 * scale)


def test_fit_vgm_matches_reference_with_injected_jitter(adult):
    ds, key, _, _ = adult
    keys = jax.random.split(key, len(ds.schema))
    for j, col in enumerate(ds.schema):
        if col.kind != "continuous":
            continue
        x = ds.data[:, j]
        ref = jvgm.fit_vgm(jnp.asarray(x, jnp.float32), keys[j])
        jitter = np.array(jax.random.normal(keys[j], (10,)))
        ours = tvgm.fit_vgm(torch.as_tensor(x, dtype=torch.float32),
                            jitter=torch.from_numpy(jitter))
        np.testing.assert_array_equal(ours.valid.numpy(),
                                      np.asarray(ref.valid))
        for f in ("weights", "means", "stds"):
            _close(getattr(ours, f).numpy(), getattr(ref, f), x)


def test_fit_vgm_prunes_and_keeps_one_mode():
    x = torch.full((200,), 3.0)
    p = tvgm.fit_vgm(x, max_modes=5, jitter=torch.zeros(5))
    assert p.valid.any()
    assert torch.isfinite(p.means).all() and torch.isfinite(p.stds).all()


def test_fit_centralized_encoders_matches_reference(adult):
    ds, key, ref_enc, _ = adult
    keys = jax.random.split(key, len(ds.schema))
    jitters = {j: torch.from_numpy(np.array(jax.random.normal(keys[j], (10,))))
               for j, c in enumerate(ds.schema) if c.kind == "continuous"}
    ours = tenc.fit_centralized_encoders(ds.data, ds.schema, jitters=jitters,
                                         device="cpu")
    assert [tuple(vars(s).values()) for s in ours.spans()] == \
        [tuple(vars(s).values()) for s in ref_enc.spans()]
    assert (ours.encoded_dim, ours.cond_dim) == (ref_enc.encoded_dim,
                                                 ref_enc.cond_dim)
    for j, le in ref_enc.label_encoders.items():
        np.testing.assert_array_equal(ours.label_encoders[j].categories,
                                      le.categories)
    for j, p in ref_enc.vgms.items():
        np.testing.assert_array_equal(ours.vgms[j].valid.numpy(),
                                      np.asarray(p.valid))
        _close(ours.vgms[j].means.numpy(), p.means, ds.data[:, j])


def test_pack_vgm_params_matches_reference(adult):
    _, _, ref_enc, port_enc = adult
    cols = sorted(ref_enc.vgms)
    theirs = jvgm.pack_vgm_params([ref_enc.vgms[j] for j in cols], 12)
    ours = tvgm.pack_vgm_params([port_enc.vgms[j] for j in cols], 12)
    for a, b in zip(ours[:2], theirs[:2]):                # means, stds
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # log-weights: XLA's and PyTorch's vectorized log differ by an ulp
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(theirs[2]),
                               rtol=1e-6, atol=0)


def test_encode_matches_reference_with_injected_gumbel(adult):
    ds, key, ref_enc, port_enc = adult
    expect = np.asarray(ref_enc.encode(ds.data, key))
    gumbel = np.array(ref_enc.plan()._draw_gumbel(key, ds.n_rows))
    with ops.dispatch_scope() as d:
        ours = port_enc.encode(ds.data,
                               gumbel=torch.from_numpy(gumbel)).numpy()
    assert dict(d) == {"vgm_encode_table_ref": 1}
    assert ours.shape == expect.shape
    tanh = np.array([s.start for s in ref_enc.spans()
                     if s.activation == "tanh"])
    onehot = np.setdiff1d(np.arange(expect.shape[1]), tanh)
    np.testing.assert_array_equal(ours[:, onehot], expect[:, onehot])
    np.testing.assert_allclose(ours[:, tanh], expect[:, tanh], rtol=1e-6,
                               atol=1e-6)


def test_decode_matches_reference_and_column_oracle(adult):
    ds, key, ref_enc, port_enc = adult
    rng = np.random.default_rng(3)
    acts = rng.normal(size=(300, ref_enc.encoded_dim)).astype(np.float32)
    expect = ref_enc.decode(jnp.asarray(acts))
    ours = port_enc.decode(torch.from_numpy(acts))
    cat = [j for j, c in enumerate(ds.schema) if c.kind == "categorical"]
    cont = [j for j, c in enumerate(ds.schema) if c.kind == "continuous"]
    assert ours.dtype == np.float64 and ours.shape == expect.shape
    np.testing.assert_array_equal(ours[:, cat], expect[:, cat])
    np.testing.assert_allclose(ours[:, cont], expect[:, cont], rtol=1e-6,
                               atol=1e-6)
    # and the per-column oracle of the fused decode
    spans = {s.column: s for s in port_enc.spans() if s.activation == "softmax"}
    for j in cont:
        s = spans[j]
        col = tvgm.decode_column(torch.from_numpy(acts[:, s.start - 1]),
                                 torch.from_numpy(acts[:, s.start:s.start + s.width]),
                                 port_enc.vgms[j]).numpy()
        np.testing.assert_array_equal(ours[:, j], col)


def test_roundtrip_recovers_the_table(adult):
    """Encode then decode gives back the raw table: categories exactly,
    continuous values up to float32 rounding (unless clipped at 4 sd)."""
    ds, _, _, port_enc = adult
    encoded = port_enc.encode(ds.data, generator=torch.Generator().manual_seed(0))
    back = port_enc.decode(encoded)
    cat = [j for j, c in enumerate(ds.schema) if c.kind == "categorical"]
    np.testing.assert_array_equal(back[:, cat], ds.data[:, cat])
    cont = [j for j, c in enumerate(ds.schema) if c.kind == "continuous"]
    alpha = encoded[:, [s.start for s in port_enc.spans()
                        if s.activation == "tanh"]].numpy()
    inside = np.abs(alpha) < 1.0
    np.testing.assert_allclose(back[:, cont][inside], ds.data[:, cont][inside],
                               rtol=1e-4, atol=1e-3)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    ds = tds.make_dataset("adult", n_rows=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenc.fit_centralized_encoders(ds.data, ds.schema)


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of repro_torch imports in a fresh interpreter without
    pulling in jax or any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules if m.startswith('repro_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.split())
    assert len(imported) >= 35
    for name in ("optim.optimizers", "gan.trainer", "kernels.weighted_agg",
                 "tabular.metrics", "core.divergence", "core.encoding",
                 "core.weighting", "core.aggregation", "core.comm_model",
                 "core.architectures", "fed.merge", "fed.setup",
                 "fed.program", "interop", "models.ssm",
                 "kernels.mlstm_chunk", "launch.serve", "gan.dp",
                 "privacy.trace", "privacy.attacks"):
        assert f"repro_torch.{name}" in imported, name


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    script = SRC.parent / "chip_smoke.py"
    text = script.read_text()
    for word in ("import jax", "from jax", "import repro\n", "from repro."):
        assert word not in text
    code = (f"import runpy, sys\nrunpy.run_path({str(script)!r}, "
            "run_name='not_main')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(SRC.parent),
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
