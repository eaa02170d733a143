"""The frozen yardstick: the table generator's continuous columns equal
the program's as they stood and its categorical columns hold the
configuration's schema, the traffic generators are deterministic in the
seed and give every seed the same work, the CTGAN FLOP formula equals a
dispatch count of one train step's matrix products, and the activations'
least work counts the encoded row's lanes."""
import collections
import json
import zlib

import numpy as np
import pytest

from _small import ROOT, SEED, SMALL

from port_bench import data, work
from port_bench.kinds import open_loop

CONFIGS = {n: json.loads((ROOT / "port_bench" / "configs"
                          / f"ctgan-{n}.json").read_text())
           for n in ("adult", "intrusion")}


@pytest.mark.parametrize("name", ["adult", "covertype", "credit",
                                  "intrusion"])
def test_table_equals_the_programs(name):
    from repro_torch.tabular import datasets
    _, _, n_cont = datasets._TABLE1[name]
    base = zlib.crc32(name.encode()) % (2 ** 31)
    for j in range(n_cont):
        np.testing.assert_array_equal(
            data._continuous_column(np.random.default_rng(11), 300,
                                    base + 1000 + j),
            datasets._continuous_column(np.random.default_rng(11), 300,
                                        base + 1000 + j))
    ds = datasets.make_dataset(name, n_rows=300, seed=11)
    for a, b in zip(data.partition_iid(ds.data, 5, 3),
                    datasets.partition_iid(ds, 5, seed=3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_category_in_every_table(name):
    cfg = CONFIGS[name]
    for seed in (SEED, 5):
        table, schema = data.make_table(cfg, 300, seed)
        assert [n for n, _ in schema] == (
            [c["name"] for c in cfg["categorical"]] + cfg["continuous"])
        for j, col in enumerate(cfg["categorical"]):
            assert sorted(set(table[:, j])) == list(range(len(col["counts"])))
    # the published shares (one row a category aside)
    big, _ = data.make_table(cfg, 20_000, 9)
    for j, col in enumerate(cfg["categorical"]):
        want = np.asarray(col["counts"]) / sum(col["counts"])
        got = np.bincount(big[:, j].astype(int)) / 20_000
        np.testing.assert_allclose(got, want, atol=0.015)


def test_tables_deterministic_in_the_seed():
    cfg = CONFIGS["adult"]
    a, _ = data.make_table(cfg, 200, data.stream_seed(SEED, 0))
    b, _ = data.make_table(cfg, 200, data.stream_seed(SEED, 0))
    c, _ = data.make_table(cfg, 200, data.stream_seed(SEED + 1, 0))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_open_loop_arrivals_same_work_every_seed():
    tr = {"rate_per_s": 400, "size_median": 512, "size_sigma": 1.0,
          "size_min": 64, "size_max": 4096, "conditional_share": 0.5,
          "base_seed": 20211217, "tenants": 8}

    def draw(seed):
        return open_loop.arrivals(tr, 20.0, np.random.default_rng(seed))
    a, b, c = draw(SEED), draw(SEED), draw(SEED + 1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[1], c[1])
    # the same multiset of (rows, conditional) and of gaps, in another order
    assert (collections.Counter(zip(a[1].tolist(), a[2].tolist()))
            == collections.Counter(zip(c[1].tolist(), c[2].tolist())))
    assert len(a[0]) == 8000 and np.all(np.diff(a[0]) >= 0)
    assert a[0][0] == 0.0 and a[0][-1] < 20.0
    assert a[1].min() >= 64 and a[1].max() <= 4096
    assert a[2].sum() == 4000


def test_ctgan_flops_equal_a_dispatch_count_of_one_step():
    import torch

    from repro_torch.counting import OpCounter
    from repro_torch.gan.trainer import init_gan_state
    from repro_torch.synth import DeviceSampler, RoundEngine
    from repro_torch.tabular.encoders import (ColumnSpec,
                                              fit_centralized_encoders)

    from port_bench.kinds.federated import ctgan_config
    torch.set_num_threads(1)
    table, schema = data.make_table(CONFIGS["adult"], 400, 5)
    cfg = ctgan_config(dict(SMALL, tau=0.2, gp_lambda=10.0, dropout=0.5,
                            lr=2e-4, b1=0.5, b2=0.9))
    g = torch.Generator().manual_seed(7)
    enc = fit_centralized_encoders(
        table, [ColumnSpec(n, k) for n, k in schema], generator=g,
        device="cpu")
    tables = DeviceSampler(enc.encode(table, generator=g).numpy(), enc,
                           "cpu").tables
    state = init_gan_state(cfg, enc.cond_dim, enc.encoded_dim, generator=g,
                           rng=g, device="cpu")
    engine = RoundEngine(cfg, enc.spans(), enc.condition_spans(),
                         batch=cfg.batch_size, local_steps=1)
    engine.local_round(state, tables)        # Adam's state made
    counter = OpCounter()
    with counter:
        engine.local_round(state, tables)
    products = counter.flops - sum(k["flops"] for k in
                                   counter.kernels.values())
    f = work.ctgan_step_flops(
        z_dim=cfg.z_dim, gen_hidden=cfg.gen_hidden,
        disc_hidden=cfg.disc_hidden, pac=cfg.pac, batch=cfg.batch_size,
        data_dim=enc.encoded_dim, cond_dim=enc.cond_dim)
    assert products == f["model"] + f["zero_grad"]
    assert f["zero_grad"] < 0.05 * f["model"]


def test_kernel_formulas_equal_the_programs():
    """Where no span is padded, the activations' least work is the
    program's formula, less its per-lane kinds (one a span here); with
    spans of different widths it counts the row's lanes, not the padded
    layout's."""
    from repro_torch.kernels import work as program_work
    for b, s, w in ((500, 19, 18), (4096, 64, 19)):
        for bwd in (False, True):
            nb, fl = work.segment_activations(b, [w] * s, backward=bwd)
            pb, pf = program_work.segment_activations(b, s, w, backward=bwd)
            assert fl == pf and pb - nb == 4 * (s * w - s)
    widths = [42, 2, 11, 1]
    assert work.segment_activations(500, widths) == (
        4 * (3 * 500 * 56 + 4), 12 * 500 * 56)
    assert work.segment_activations(500, widths, backward=True) == (
        4 * (4 * 500 * 56 + 4), 16 * 500 * 56)
    assert work.vgm_decode_table(4096, 22, 10) == \
        program_work.vgm_decode_table(4096, 22, 10)
