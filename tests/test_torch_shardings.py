"""The port's sharding rules and policy (``models/layers.py``,
``launch/shardings.py``) and input specs (``launch/input_specs.py``)
against the JAX package's, for all ten architectures at their full
configs, on the production meshes (16x16 and 2x16x16), with ``fsdp`` on
and off and every ``moe_mode``.

Shapes come from ``jax.eval_shape`` on the reference side and from the
meta device on the port's; neither allocates.  The reference's policy
reads only ``mesh.shape`` and ``mesh.axis_names``, the port's only
``mesh_dim_names`` and ``shape``, so stand-ins serve both without 256
devices.  The reference stacks every layer leaf over a leading ``n_rep``
axis (and every cache leaf): its spec's leading entry must be None and the
rest must equal the port's spec of the same leaf in every repetition.
Specs and shapes are compared exactly.  The local shapes of the
distributed shards, on a fake world of the mesh's size, are held to
``ceil(dim / prod(axis sizes))`` (``dim // prod`` where it divides).
"""
import functools
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import input_specs as jinput  # noqa: E402
from repro.launch import shardings as jshard  # noqa: E402
from repro.models import Transformer as JTransformer  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.config import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.launch import input_specs, shardings  # noqa: E402
from repro_torch.launch.mesh import (PRODUCTION, dp_axes, fake_world,  # noqa: E402
                                     make_mesh, tp_axis)
from repro_torch.models import INPUT_SHAPES, Transformer, tree_items  # noqa: E402
from repro_torch.models import layers  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return jax.eval_shape(JTransformer(jget_config(arch)).init,
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return Transformer(get_config(arch)).init(device="meta")


def _ref_leaves(tree):
    """{path: leaf} of a reference tree, keys joined by '/'."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx",
                                                    getattr(k, "name", k))))
                     for k in kp): leaf for kp, leaf in flat}


def _ref_path(path: str) -> str:
    """The port's ``layers/<i>/...`` path as the reference's stacked one."""
    parts = path.split("/")
    if parts[0] == "layers":
        del parts[1]
    return "/".join(parts)


def _same_specs(port_specs, ref_specs, *, stacked=lambda path: True):
    """Every port spec equals its reference spec with the stacked axis
    dropped; returns the number of leaves compared."""
    ref = _ref_leaves(ref_specs)
    n = 0
    for path, spec in tree_items(port_specs):
        want = tuple(ref[_ref_path(path)])
        if stacked(path):
            assert want[0] is None, (path, want)
            want = want[1:]
        assert tuple(spec) == want, (path, tuple(spec), want)
        n += 1
    return n


def _stand_ins(multi_pod):
    dims, axes = PRODUCTION[multi_pod]
    port = SimpleNamespace(mesh_dim_names=axes, shape=dims)
    ref = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, dims)))
    return port, ref


def _is_layer(path):
    return path.startswith("layers/")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_partition_rules_match_reference(arch):
    for expert_sharded in (False, True):
        mine = layers.build_param_specs(port_params(arch),
                                        expert_sharded=expert_sharded)
        ref = jlayers.build_param_specs(ref_params(arch),
                                        expert_sharded=expert_sharded)
        assert _same_specs(mine, ref, stacked=_is_layer) > 0
    paths = layers.tree_paths(port_params(arch))
    assert [p for _, p in tree_items(paths)] == [
        p for p, _ in tree_items(port_params(arch))]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(arch, multi_pod):
    mesh, jmesh = _stand_ins(multi_pod)
    cfg = get_config(arch)
    for fsdp in (True, False):
        for moe_mode in ("auto", "f2d", "ep_pad"):
            mine = shardings.build_param_specs(
                port_params(arch), shardings.ShardPolicy(mesh, fsdp, moe_mode),
                cfg.n_experts)
            ref = jshard.build_param_specs(
                ref_params(arch), jshard.ShardPolicy(jmesh, fsdp, moe_mode),
                cfg.n_experts)
            _same_specs(mine, ref, stacked=_is_layer)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_specs_match_reference(arch, multi_pod):
    mesh, jmesh = _stand_ins(multi_pod)
    pol, jpol = shardings.ShardPolicy(mesh), jshard.ShardPolicy(jmesh)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in INPUT_SHAPES.items():
        mine = shardings.build_batch_specs(
            input_specs.input_specs(cfg, shape), pol)
        ref = jshard.build_batch_specs(
            jinput.input_specs(jcfg, JSHAPES[name]), jpol)
        _same_specs(mine, ref, stacked=lambda p: False)
    for name in ("decode_32k", "long_500k"):
        shape = INPUT_SHAPES[name]
        B, S = shape.global_batch, shape.seq_len
        caches = Transformer(cfg).init_caches(B, S, device="meta")
        jcaches = jax.eval_shape(lambda: JTransformer(jcfg).init_caches(B, S))
        mine = shardings.build_cache_specs(caches, pol)
        ref = list(_ref_leaves(jshard.build_cache_specs(jcaches,
                                                        jpol)).values())
        for rep in mine:          # every repetition as the stacked leaf,
            got = [tuple(s) for _, s in tree_items(rep)]   # in tree order
            assert all(r[0] is None for r in ref)
            assert got == [tuple(r)[1:] for r in ref], (name, got, ref)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in INPUT_SHAPES.items():
        mine = input_specs.input_specs(cfg, shape)
        ref = jinput.input_specs(jcfg, JSHAPES[name])
        assert sorted(mine) == sorted(ref)
        for k, t in mine.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[k].shape), (name, k)
            assert str(t.dtype).replace("torch.", "") == str(ref[k].dtype)


def _local_shapes_ok(mesh, tree, specs) -> int:
    """Distribute every leaf of ``tree`` by its spec and hold rank 0's
    shard to the arithmetic; returns the leaves checked."""
    from torch.distributed.tensor import distribute_tensor
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec_of = dict(tree_items(specs))
    n = 0
    for path, leaf in tree_items(tree):
        spec = spec_of[path]
        local = distribute_tensor(leaf.detach(), mesh,
                                  shardings.placements(mesh, spec)).to_local()
        want = []
        for dim, entry in zip(leaf.shape, spec):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            ways = 1
            for a in axes:
                ways *= sizes[a]
            want.append(dim // ways if dim % ways == 0 else -(-dim // ways))
        assert tuple(local.shape) == tuple(want), (path, spec, local.shape)
        n += 1
    return n


def _first_rep(params):
    return {k: ([v[0]] if k == "layers" else v) for k, v in params.items()}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_local_shapes_follow_the_arithmetic(multi_pod):
    """Rank 0's shards under every policy: ``("pod","data")`` on one dim,
    f2d's data x model, the divisibility fallback (hubert's vocab 504) and
    ep_pad's uneven expert split, from a real DeviceMesh on the fake
    backend (made and destroyed here)."""
    dims, axes = PRODUCTION[multi_pod]
    world = 1
    for d in dims:
        world *= d
    with fake_world(world):
        mesh = make_mesh(dims, axes)
        n = 0
        for arch in ARCH_NAMES:
            cfg = get_config(arch)
            params = _first_rep(port_params(arch))
            modes = ("auto", "f2d", "ep_pad") if cfg.n_experts else ("auto",)
            for moe_mode in modes:
                pol = shardings.ShardPolicy(mesh, True, moe_mode)
                specs = shardings.build_param_specs(params, pol,
                                                    cfg.n_experts)
                n += _local_shapes_ok(mesh, params, specs)
            pol = shardings.ShardPolicy(mesh)
            caches = Transformer(cfg).init_caches(1, 1024, device="meta")[:1]
            n += _local_shapes_ok(mesh, caches,
                                  shardings.build_cache_specs(caches, pol))
        assert n > 100
        assert dp_axes(mesh) == axes[:-1] and tp_axis(mesh) == "model"
        specs = shardings.build_param_specs(
            _first_rep(port_params("mixtral-8x22b")),
            shardings.ShardPolicy(mesh), 8)
        named = shardings.named(mesh, specs)
        experts = specs["layers"][0]["pos0"]["moe"]["experts"]
        for got, spec in ((named["embed"], specs["embed"]),
                          (named["layers"][0]["pos0"]["moe"]["experts"][
                              "w_up"], experts["w_up"])):
            assert got == shardings.placements(mesh, spec)
    assert not torch.distributed.is_initialized()


def test_spec_placements_refuse_axes_out_of_mesh_order():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    P = layers.PartitionSpec
    from torch.distributed.tensor import Replicate, Shard
    assert layers.spec_placements(P(("pod", "data"), "model"), mesh) == [
        Shard(0), Shard(0), Shard(1)]
    assert layers.spec_placements(P(None, ("data", "model")), mesh) == [
        Replicate(), Shard(1), Shard(1)]
    with pytest.raises(ValueError):
        layers.spec_placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError):
        layers.spec_placements(P("data", "data"), mesh)


def test_fallbacks_take_dtensor_refusals_only():
    """``ReshardFallbacks`` gets past what DTensor refuses (a reshape that
    splits a sharded dim into pieces the mesh does not divide: 6 over 2
    ranks into 3 x 2) by gathering, and records it; an op that fails on
    its own (a reshape to a wrong size) raises as it would without the
    mode, and nothing is replicated to get past it."""
    from torch.distributed.tensor import Shard, distribute_tensor
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        x = distribute_tensor(torch.empty((2, 6, 8), device="meta"), mesh,
                              [Shard(0), Shard(1)])
        with shardings.ReshardFallbacks() as fb:
            y = x.view(2, 3, 2, 8)
        assert tuple(y.shape) == (2, 3, 2, 8)
        assert dict(fb.fallbacks) == {"gather:aten.view.default": 1}
        with shardings.ReshardFallbacks() as fb:
            with pytest.raises(RuntimeError, match="invalid"):
                x.view(2, 7, 8)
        assert not fb.fallbacks
    assert not torch.distributed.is_initialized()
