"""The port's dry runs (``launch/dryrun.py``, ``launch/fed_dryrun.py``) on
fake process groups: every architecture's smoke config in train,
prefill and decode on a 2x2 mesh.

Each record must be OK (SKIP exactly where ``supported_shapes`` skips),
and its per-rank ``argument_size_in_bytes`` must equal an independent sum
of rank 0's shard bytes computed from the specs (``ceil(dim / ways)`` per
sharded dim), exactly.  Every fake group is made and destroyed inside the
dry run; each test checks that none is left.  No JAX: the dry runs are
the port's own (their specs are held to the reference's in
``test_torch_shardings.py``).  Every combo runs in this one file, in one
process: DTensor caches its sharding decisions, and the first train and
decode combos of a process pay most of the planning (llama3-8b's ~16 and
~10 s), which later architectures then share; the dense ones go first.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_dryrun_cases import (MODES, check_smoke_combo,  # noqa: E402
                                no_group_left, one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread", "no_group_left")

ARCHS = ['llama3-8b', 'smollm-135m', 'chatglm3-6b', 'qwen2.5-32b',
         'llama4-maverick-400b-a17b', 'mixtral-8x22b', 'hubert-xlarge',
         'llama-3.2-vision-11b', 'jamba-1.5-large-398b', 'xlstm-1.3b']


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_combo_on_a_2x2_mesh(arch, mode):
    check_smoke_combo(arch, mode)


def test_decode_groups_query_heads_locally_past_the_kv_heads():
    """chatglm3-6b's grouping (32 query heads over 2 KV heads, 16 to a
    group) at its smoke widths, decode, on a fake 2x16 mesh: 2 KV heads
    over 16 model ranks.  The query takes the cache's layout before the
    grouping reshape, so the combo is OK (its full-size 16x16 decode_32k
    failed with a local reshape DTensor could not do); each attention
    layer counts its three moves in the record, as the gathers are
    counted."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import InputShape
    from torch_dryrun_cases import dryrun
    cfg = dataclasses.replace(get_smoke_config("chatglm3-6b"), n_heads=32,
                              head_dim=32)
    shape = InputShape("decode_32k", 4096, 16, "decode")
    rec = dryrun.run_combo("chatglm3-6b", "decode_32k", mesh_shape=(2, 16),
                           cfg=cfg, shape=shape, verbose=False)
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["memory"]["argument_size_in_bytes"] == \
        dryrun.spec_argument_bytes(cfg, shape, (2, 16))
    for what in ("decode_q", "decode_scores", "decode_out"):
        assert rec["fallbacks"][f"reshard:{what}"] == cfg.n_layers
