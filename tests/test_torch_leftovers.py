"""The port's ``sgd``, ``pytree_bytes``, ``jain_index`` and the scheduler's
pass accounting against the JAX package's (``optim/optimizers.py:sgd``,
``core/comm_model.py:pytree_bytes``, ``serve/scheduling.py:jain_index``,
``ContinuousScheduler.cycles`` / ``backlogged`` / ``starvation_bound``).

Tolerances: SGD parameters and momentum buffers rtol 1e-6 (float32, the
same operations in the same order; only the rounding of ``lr * g`` may
differ by an ulp); byte counts, Jain's index and the scheduler's
admissions and pass counts equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import comm_model as jcomm  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.serve import scheduling as jsched  # noqa: E402
from repro_torch.core import comm_model  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.serve.scheduling import jain_index  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = [(3, 4), (5,), (2, 2, 3)]


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("lr", [1e-2, "cosine"])
def test_sgd_three_steps_match_reference(momentum, lr):
    rng = np.random.default_rng(0)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    if lr == "cosine":
        j_lr = jopt.cosine_schedule(0.1, 1, 3)
        from repro_torch.optim import cosine_schedule
        t_lr = cosine_schedule(0.1, 1, 3)
    else:
        j_lr = t_lr = lr
    jo = jopt.sgd(j_lr, momentum)
    jp = [jnp.asarray(p) for p in params]
    js = jo.init(jp)
    to = sgd(t_lr, momentum)
    tp = [torch.tensor(p) for p in params]
    ts = to.init(tp)
    for g in grads:
        jp, js = jo.update([jnp.asarray(x) for x in g], js, jp)
        ts = to.update([torch.tensor(x) for x in g], ts, tp)
    assert ts.count == int(js[1]) == 3
    for a, b in zip(tp, jp, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    if momentum:
        for a, b in zip(ts.buf, js[0], strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    else:
        assert ts.buf is None and js[0] is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_pytree_bytes_matches_reference(dtype):
    tree = {"a": np.zeros((3, 4)), "b": [np.zeros((5,)), np.zeros((2, 7))],
            "c": {"d": np.zeros(())}}

    def conv(x, to):
        if isinstance(x, dict):
            return {k: conv(v, to) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v, to) for v in x]
        return to(x)
    jtree = conv(tree, lambda x: jnp.zeros(x.shape, getattr(jnp, dtype)))
    ttree = conv(tree, lambda x: torch.zeros(x.shape,
                                             dtype=getattr(torch, dtype)))
    assert comm_model.pytree_bytes(ttree) == jcomm.pytree_bytes(jtree)


@pytest.mark.parametrize("values", [
    [], [0.0, 0.0], [1.0, 1.0, 1.0], [5.0, 0.0, 0.0, 0.0], [3.0, 1.0, 2.5],
    np.random.default_rng(1).uniform(0, 10, 17).tolist()])
def test_jain_index_matches_reference(values):
    assert jain_index(values) == jsched.jain_index(values)


def test_jain_index_refuses_negative_allocations():
    for fn in (jain_index, jsched.jain_index):
        with pytest.raises(ValueError):
            fn([1.0, -1.0])


def test_scheduler_pass_accounting_matches_reference():
    """``cycles``, ``pushed_cycle`` / ``admitted_cycle``, ``backlogged``
    and ``starvation_bound`` over one trace through both schedulers."""
    from repro_torch.serve.scheduling import ContinuousScheduler
    trace = [("a", 300), ("a", 700), ("b", 100), ("c", 1200), ("a", 50),
             ("b", 900), ("c", 10)]
    mine, ref = ContinuousScheduler(512), jsched.ContinuousScheduler(512)
    got, want = [], []
    for i, (tenant, cost) in enumerate(trace):
        got.append(mine.push(tenant, i, cost))
        want.append(ref.push(tenant, i, cost))
        if i % 3 == 2:
            assert ([r.item for r in mine.assemble()]
                    == [r.item for r in ref.assemble()])
        assert mine.backlogged() == ref.backlogged()
    while len(ref):
        assert ([r.item for r in mine.assemble()]
                == [r.item for r in ref.assemble()])
    assert len(mine) == 0 and mine.cycles == ref.cycles
    assert [(a.pushed_cycle, a.admitted_cycle) for a in got] == [
        (a.pushed_cycle, a.admitted_cycle) for a in want]
    for ahead, top in ((1, 1), (512, 100), (2000, 1200)):
        assert (mine.starvation_bound(ahead, top)
                == ref.starvation_bound(ahead, top))
