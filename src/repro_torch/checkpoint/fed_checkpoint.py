"""Federated-run checkpoints: every client's state, the round cursor and
the retry blocklist, the port's copy of the JAX package's ``checkpoint/
fed_checkpoint.py``.

``setup_federation`` is deterministic in (client data, schema, config,
seed), so only the per-client states, the absolute round cursor (rounds
done, the next round to run) and the blocklist are kept.  The keys are
the reference's tree paths of its stacked ``GANState`` (``states/
.g_params/res0/fc/w``, ``states/.d_opt/.mu/fc0/b``, ``states/.g_opt/
.count``, ``states/.step``, ..., Linear weights in its ``(fan_in,
fan_out)`` layout, a leading client axis) and ``blocked``, so the
reference's ``restore_fed_checkpoint`` reads a port-written file and this
module reads a reference-written one.

The random streams do not carry across packages: JAX keys and
``torch.Generator`` states have no common form.  Each client's generator
state is kept under the port's own key :data:`TORCH_RNG_KEY`, so a
resumed port run equals the uninterrupted one; ``states/.rng`` holds each
generator's initial seed as a two-word key, for the reference to have a
distinct valid key per client.  A reference-written file has no
:data:`TORCH_RNG_KEY`: its states resume with the generators they had.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..gan.trainer import GANState
from ..interop import _layout, _tensor
from ..optim import AdamState
from .checkpoint import restore_checkpoint, save_checkpoint

TORCH_RNG_KEY = "states/torch_rng"


def _modules(st: GANState):
    return (("g", st.gen, st.g_opt), ("d", st.disc, st.d_opt))


def _state_arrays(states: Sequence[GANState]) -> dict[str, np.ndarray]:
    flat: dict[str, list] = {}

    def put(key, arr):
        flat.setdefault(key, []).append(arr)
    for st in states:
        for net, module, opt in _modules(st):
            for i, (param, key, tr) in enumerate(_layout(module)):
                for prefix, t in ((f".{net}_params", param),
                                  (f".{net}_opt/.mu", opt.mu[i]),
                                  (f".{net}_opt/.nu", opt.nu[i])):
                    a = t.detach().float().cpu().numpy()
                    put(f"states/{prefix}/{key}", a.T if tr else a)
            put(f"states/.{net}_opt/.count", np.int32(opt.count))
        put("states/.step", np.int32(st.step))
        seed = st.rng.initial_seed()
        put("states/.rng", np.array([seed >> 32, seed & 0xFFFFFFFF],
                                    np.uint32))
        put(TORCH_RNG_KEY, st.rng.get_state().numpy())
    return {k: np.stack(v) for k, v in flat.items()}


def save_fed_checkpoint(ckpt_dir: str, round_idx: int,
                        states: Sequence[GANState], blocked=None) -> str:
    """Write the run at round cursor ``round_idx`` (rounds completed);
    ``blocked`` is the (P,) bool retry blocklist (nobody by default)."""
    flat = _state_arrays(states)
    flat["blocked"] = np.asarray(
        np.zeros(len(states), bool) if blocked is None else blocked, bool)
    return save_checkpoint(ckpt_dir, round_idx, flat,
                           treedef=f"repro_torch GANState x {len(states)}")


@torch.no_grad()
def restore_fed_checkpoint(ckpt_dir: str, like_states: Sequence[GANState],
                           n_clients: int, step: int | None = None):
    """Load the latest (or checkpoint ``step``) into ``like_states`` in
    place; returns ``(round_idx, like_states, blocked)``."""
    step, flat = restore_checkpoint(ckpt_dir, step)
    if len(like_states) != n_clients:
        raise ValueError(f"{len(like_states)} states for {n_clients} clients")
    for p, st in enumerate(like_states):
        def row(key):
            return {key: flat[key][p]}
        opts = {}
        for net, module, opt in _modules(st):
            mus, nus = [], []
            for param, key, tr in _layout(module):
                k = f"states/.{net}_params/{key}"
                param.copy_(_tensor(row(k), k, tr, param))
                for prefix, out in (("mu", mus), ("nu", nus)):
                    k = f"states/.{net}_opt/.{prefix}/{key}"
                    out.append(_tensor(row(k), k, tr, param))
            opts[net] = AdamState(mus, nus, int(
                flat[f"states/.{net}_opt/.count"][p]))
        st.g_opt, st.d_opt = opts["g"], opts["d"]
        st.step = int(flat["states/.step"][p])
        if TORCH_RNG_KEY in flat:
            st.rng.set_state(torch.from_numpy(flat[TORCH_RNG_KEY][p].copy()))
    return step, like_states, np.asarray(flat["blocked"], bool)
