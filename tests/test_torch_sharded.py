"""The collective rendering of the federated round (one client per rank of
a ``torch.distributed`` group) held against the JAX package's ``shard_map``
rendering and against the port's own fused round, on the CPU over gloo.

The world-size-1 group is made once for the module (a file store under a
temporary directory) and destroyed at its end, whatever happens: a group
left open would break every later test of the process.  The two-rank test
runs in two spawned processes of its own.

Tolerances:
  * ``psum_weighted`` / ``broadcast_from`` at world size 1: exact (a
    float32 product by the weight; a broadcast is a copy).
  * the toy round against the reference's ``shard_map`` round on a
    one-device mesh: rtol 1e-6, atol 1e-7 -- the same float32 operations,
    which XLA may contract into fused multiply-adds.
  * ``shard_map_global_round`` at P = 1 against ``FederatedProgram.
    global_round``: bit-identical (the weight is 1, the all-reduce of one
    rank returns its input, and the local round is the same code).
  * two ranks: ``psum_weighted`` within rtol 1e-6 of ``weighted_average``
    of the two ranks' tensors (gloo sums in its own order), and equal on
    both ranks; ``broadcast_from`` exact.
"""
import tempfile
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.core import fedavg as jfedavg  # noqa: E402
from repro_torch.core.aggregation import (broadcast_from,  # noqa: E402
                                          psum_weighted, weighted_average)
from repro_torch.core.architectures import _clone_states  # noqa: E402
from repro_torch.core.fedavg import (make_federated_round,  # noqa: E402
                                     shard_map_federated_round)
from repro_torch.fed import (FederatedProgram,  # noqa: E402
                             setup_federation, shard_map_global_round,
                             shard_map_weighted_round)
from repro_torch.gan.ctgan import CTGANConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.tabular import make_dataset, partition_iid  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CFG = CTGANConfig(z_dim=8, gen_hidden=(16, 16), disc_hidden=(16, 16),
                  pac=2, batch_size=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The default group: gloo, world size 1."""
    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield None
    finally:
        dist.destroy_process_group()


def test_psum_weighted_and_broadcast_at_world_size_1(group):
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for s in ((3, 4), (5,), ())]
    local = [x.clone() for x in xs]
    out = psum_weighted(local, torch.tensor(0.25), group)
    assert out is local                               # written in place
    for a, x in zip(local, xs):
        assert torch.equal(a, x * 0.25)
    one = xs[0].clone()
    assert psum_weighted(one, 1.0) is one and torch.equal(one, xs[0])
    back = broadcast_from([x.clone() for x in xs], src=0, group=group)
    for a, x in zip(back, xs):
        assert torch.equal(a, x)


class St(NamedTuple):
    params: object
    step: object


def _sgd_step(state, batch):
    """The reference's toy step (``tests/test_fedavg_features.py``): a pull
    toward the batch value; works on either package's arrays."""
    grad = state.params - batch
    return St(state.params - 0.1 * grad, state.step + 1), {"g": grad.sum()}


def test_federated_round_matches_reference_on_one_device_mesh(group):
    """``make_federated_round`` and ``shard_map_federated_round`` of the
    toy step against the reference's ``shard_map_federated_round`` on
    ``jax.make_mesh((1,), ("clients",))``: the merged params, the step
    count and the per-step metrics."""
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(4,)).astype(np.float32)
    batches = rng.normal(size=(1, 3, 4)).astype(np.float32)   # (P, E, ...)
    w = np.ones(1, np.float32)
    mesh = jax.make_mesh((1,), ("clients",))
    wrapped = jfedavg.shard_map_federated_round(
        mesh, _sgd_step, St(PartitionSpec(), PartitionSpec()),
        client_axis="clients")
    with mesh:
        jst, jm = jax.jit(wrapped)(
            St(jnp.asarray(p0), jnp.zeros((), jnp.int32)),
            jnp.asarray(batches), jnp.asarray(w))
    rounds = {
        "make_federated_round": lambda st: make_federated_round(
            _sgd_step, group=group)(st, torch.from_numpy(batches[0]),
                                    torch.tensor(1.0)),
        "shard_map_federated_round": lambda st: shard_map_federated_round(
            _sgd_step, group=group)(st, torch.from_numpy(batches),
                                    torch.from_numpy(w)),
    }
    for name, run in rounds.items():
        st, m = run(St(torch.from_numpy(p0.copy()), torch.tensor(0)))
        np.testing.assert_allclose(st.params.numpy(), np.asarray(jst.params),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        assert int(st.step) == int(jst.step) == 3
        g = m["g"][None] if name == "make_federated_round" else m["g"]
        assert g.shape == (1, 3) == jm["g"].shape
        np.testing.assert_allclose(g.numpy(), np.asarray(jm["g"]), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def one_client():
    ds = make_dataset("adult", n_rows=160, seed=2)
    [part] = partition_iid(ds, 1, seed=2)
    return setup_federation([part], ds.schema, CFG, 2, "fedtgan",
                            device="cpu")


@pytest.mark.parametrize("weighting", ["fedtgan", "uniform"])
def test_shard_map_global_round_is_the_fused_round_at_p1(group, one_client,
                                                          weighting):
    fe = one_client
    prog = FederatedProgram(CFG, fe.spans, fe.cond_spans,
                            batch=CFG.batch_size, local_steps=2,
                            weighting=weighting)
    sm = shard_map_global_round(CFG, fe.spans, fe.cond_spans,
                                batch=CFG.batch_size, local_steps=2,
                                weighting=weighting, group=group)
    fused, fm = prog.global_round(_clone_states(fe.states), fe.tables, fe.S,
                                  fe.n_rows)
    with ops.dispatch_scope() as d:
        coll, cm = sm(_clone_states(fe.states), fe.tables, fe.S, fe.n_rows)
    assert "weighted_agg_ref" not in d and "weighted_agg" not in d
    assert d["segment_activations_ref"] == 2 * 2       # critic and generator
    assert cm.keys() == fm.keys() and cm["d_loss"].shape == (1, 2)
    for k in fm:
        assert torch.equal(cm[k], fm[k]), k
    for a, b in zip(coll[0].params(), fused[0].params(), strict=True):
        assert torch.equal(a, b)


def test_size_mismatch_raises(group, one_client):
    fe = one_client
    round_fn = shard_map_weighted_round(FederatedProgram(
        CFG, fe.spans, fe.cond_spans, batch=CFG.batch_size,
        local_steps=1).engine, group=group)
    two = _clone_states(fe.states) * 2
    with pytest.raises(ValueError, match=r"client states \(2\) must equal"):
        round_fn(two, fe.tables * 2, torch.tensor([0.5, 0.5]))
    wrapped = shard_map_federated_round(_sgd_step, group=group)
    with pytest.raises(ValueError, match="2 client weights for a group of 1"):
        wrapped(St(torch.zeros(4), torch.tensor(0)), torch.zeros((2, 1, 4)),
                torch.tensor([0.5, 0.5]))


# ---- two ranks -----------------------------------------------------------

W2 = (0.3, 0.7)


def _rank_tensors(rank):
    return [torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
            + 0.5, torch.full((4,), rank - 3.0)]


def _two_rank_worker(rank, store, out_dir):
    """One rank of the two-rank gloo group (run in a spawned process)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2)
    try:
        merged = psum_weighted(_rank_tensors(rank), torch.tensor(W2[rank]))
        bcast = broadcast_from(_rank_tensors(rank), src=1)
        torch.save({"merged": merged, "bcast": bcast},
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_two_ranks_over_gloo():
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_two_rank_worker,
                             args=(r, f"{tmp}/store", tmp)) for r in (0, 1)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=120)
        alive = [p.is_alive() for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        assert not any(alive), "a rank did not finish within 120 s"
        assert [p.exitcode for p in procs] == [0, 0]
        out = [torch.load(f"{tmp}/rank{r}.pt") for r in (0, 1)]
    expect = weighted_average(
        [torch.stack(leaves) for leaves in zip(*map(_rank_tensors, (0, 1)))],
        torch.tensor(W2))
    for o in out:
        for a, b in zip(o["merged"], expect, strict=True):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        for a, b in zip(o["bcast"], _rank_tensors(1), strict=True):
            assert torch.equal(a, b)
    for a, b in zip(out[0]["merged"], out[1]["merged"]):
        assert torch.equal(a, b)
