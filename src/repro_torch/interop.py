"""Carry state across from the JAX package, as numpy arrays.

The reference's checkpoints are flat ``.npz`` files keyed by tree path
(``checkpoint/checkpoint.py``).  ``generator_from_reference`` and
``discriminator_from_reference`` take one network's parameters in that
key format (``"res0/fc/w"``, ``"res0/bn_scale"``, ``"fc0/b"``, ``"out/w"``,
...) with Linear weights in ``(fan_in, fan_out)`` layout, and return the
port's module; ``gan_state_from_reference`` takes a whole flattened
``GANState`` (``".g_params/..."``, ``".d_params/..."``, ``".g_opt/.mu/..."``,
``".g_opt/.nu/..."``, ``".g_opt/.count"``, the same for ``.d_opt``, and
``".step"``) and returns the port's :class:`GANState` with both Adam
states.  ``encoders_from_reference`` takes per-column VGM arrays and
label-encoder categories and returns the port's :class:`TableEncoders`.
``lm_params_from_reference`` takes a flattened ``Transformer`` parameter
tree (``embed``, ``final_norm``, ``layers/pos0/pre_norm``,
``layers/pos0/attn/wq``, ..., ``layers/pos0/ffn/w_down``, every leaf under
``layers`` with a leading ``n_rep`` axis) and returns the port's parameter
dict; ``lm_train_state_from_reference`` takes a flattened ``TrainState``
(``.params/...``, ``.opt_state/.mu/...``, ``.opt_state/.nu/...``,
``.opt_state/.count``, ``.step``) and returns the port's
:class:`repro_torch.models.TrainState`; both take every block kind
(``layers/pos0/mlstm/...``, ``layers/pos1/slstm/slstm_r``,
``layers/pos0/mamba/ssm_a``, ``layers/pos4/xattn_gate``, the MoE's
``layers/pos0/moe/router`` and ``layers/pos0/moe/experts/w_gate`` (E, D,
F) stacks) and the frame inputs' ``in_proj``.
``lm_caches_from_reference`` takes the flattened decode caches of the
reference's ``Transformer.prefill`` or ``init_caches`` (``pos0/.C``,
``pos1/.h``, ``pos0/.k``, ``pos0/.length``, ``pos0/.conv_buf``, a
cross-attention block's placeholder ``pos4``, ..., each with a leading
``n_rep`` axis) and returns the port's cache list.  With these, the two
packages compute from the same state.  ``gan_flat_index`` maps the flat
``(P, D)`` update stack that the port's merge reads to the reference's
layout and back (``flat_to_reference``, ``flat_from_reference``), so that
a privacy trace recorded by either package replays in the other.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .device import resolve_device
from .gan.ctgan import CTGANConfig, Discriminator, Generator
from .gan.trainer import GANState
from .models import ModelConfig, TrainState, tree_items, tree_leaves
from .models.attention import KVCache
from .models.ssm import MambaState, MLSTMState, SLSTMState
from .optim import AdamState
from .tabular.encoders import ColumnSpec, LabelEncoder, TableEncoders
from .tabular.vgm import VGMParams


def _layout(module: torch.nn.Module) -> list[tuple[torch.Tensor, str, bool]]:
    """(parameter, reference key, transposed) in ``module.parameters()``
    order: ``res.0.fc.weight`` is ``res0/fc/w`` (transposed), ``fc.1.bias``
    is ``fc1/b``, ``res.0.bn_scale`` is ``res0/bn_scale``."""
    out = []
    for name, param in module.named_parameters():
        parts: list[str] = []
        for part in name.split("."):
            if part.isdigit():
                parts[-1] += part
            else:
                parts.append(part)
        last = parts[-1]
        parts[-1] = {"weight": "w", "bias": "b"}.get(last, last)
        out.append((param, "/".join(parts), last == "weight"))
    return out


def _tensor(flat: Mapping[str, np.ndarray], key: str, transpose: bool,
            like: torch.Tensor) -> torch.Tensor:
    a = np.asarray(flat[key], np.float32)
    a = np.array(a.T if transpose else a, order="C")
    if tuple(like.shape) != a.shape:
        raise ValueError(f"{key}: shape {a.shape} does not fit "
                         f"{tuple(like.shape)}")
    return torch.from_numpy(a).to(like.device)


def _load(layout, flat: Mapping[str, np.ndarray]) -> None:
    with torch.no_grad():
        for param, key, transpose in layout:
            param.copy_(_tensor(flat, key, transpose, param))


def generator_from_reference(flat: Mapping[str, np.ndarray], *,
                             device: torch.device | str = "cuda") -> Generator:
    """The port's generator holding the reference's parameters; its widths
    are read off the arrays' shapes."""
    dev = resolve_device(device)
    n_hidden = len({k.split("/")[0] for k in flat if k.startswith("res")})
    w0 = np.asarray(flat["res0/fc/w"]) if n_hidden else np.asarray(flat["out/w"])
    hidden = [np.asarray(flat[f"res{i}/fc/w"]).shape[1] for i in range(n_hidden)]
    data_dim = np.asarray(flat["out/w"]).shape[1]
    gen = Generator(w0.shape[0], hidden, data_dim, device=dev)
    _load(_layout(gen), flat)
    return gen


def discriminator_from_reference(flat: Mapping[str, np.ndarray], *,
                                 pac: int, dropout: float,
                                 device: torch.device | str = "cuda"
                                 ) -> Discriminator:
    """The port's critic holding the reference's parameters; its widths are
    read off the arrays' shapes, ``pac`` and ``dropout`` come from the
    config (the first fan-in is ``in_dim * pac``)."""
    dev = resolve_device(device)
    n_hidden = len({k.split("/")[0] for k in flat if k.startswith("fc")})
    fan_in = np.asarray(flat["fc0/w" if n_hidden else "out/w"]).shape[0]
    if fan_in % pac:
        raise ValueError(f"first fan-in {fan_in} is not a multiple of "
                         f"pac={pac}")
    hidden = [np.asarray(flat[f"fc{i}/w"]).shape[1] for i in range(n_hidden)]
    disc = Discriminator(fan_in // pac, hidden, pac=pac, dropout=dropout,
                         device=dev)
    _load(_layout(disc), flat)
    return disc


def _adam_from_reference(flat: Mapping[str, np.ndarray], prefix: str,
                         layout) -> AdamState:
    def moments(name):
        return [_tensor(flat, f"{prefix}/.{name}/{key}", transpose, param)
                for param, key, transpose in layout]
    return AdamState(moments("mu"), moments("nu"),
                     int(np.asarray(flat[f"{prefix}/.count"])))


def gan_state_from_reference(flat: Mapping[str, np.ndarray],
                             cfg: CTGANConfig, *,
                             rng: torch.Generator | None = None,
                             device: torch.device | str = "cuda") -> GANState:
    """The port's :class:`GANState` from a flattened reference ``GANState``:
    both networks, both Adam states (moments transposed as their weights)
    and ``step``.  The reference's PRNG key has no counterpart: the state
    draws from ``rng`` (a fresh generator on ``device`` when not given)."""
    dev = resolve_device(device)

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}
    gen = generator_from_reference(sub(".g_params/"), device=dev)
    disc = discriminator_from_reference(sub(".d_params/"), pac=cfg.pac,
                                        dropout=cfg.dropout, device=dev)
    return GANState(
        gen, disc,
        _adam_from_reference(flat, ".g_opt", _layout(gen)),
        _adam_from_reference(flat, ".d_opt", _layout(disc)),
        int(np.asarray(flat[".step"])),
        rng if rng is not None else torch.Generator(device=dev))


def gan_flat_index(gen: Generator, disc: Discriminator) -> np.ndarray:
    """The map between the two packages' flat update stacks of one model:
    ``reference = port[..., index]``.

    The port flattens :meth:`GANState.params` (generator then critic, in
    ``parameters()`` order, torch's ``(out, in)`` weights); the reference
    flattens ``{"g": g_params, "d": d_params}`` with ``jax.tree``, which
    sorts dict keys at every level (so the critic comes first, ``fc0/b``
    before ``fc0/w``) and keeps each ``(fan_in, fan_out)`` weight
    row-major."""
    entries, off = [], 0
    for prefix, module in (("g", gen), ("d", disc)):
        for param, key, transposed in _layout(module):
            n = param.numel()
            idx = np.arange(off, off + n, dtype=np.int64).reshape(param.shape)
            entries.append(((prefix, *key.split("/")),
                            (idx.T if transposed else idx).reshape(-1)))
            off += n
    return np.concatenate([idx for _, idx in sorted(entries,
                                                    key=lambda e: e[0])])


def flat_to_reference(flat, index: np.ndarray):
    """Port-layout flat parameters (``(..., D)``, numpy or torch) in the
    reference's layout (:func:`gan_flat_index`)."""
    if isinstance(flat, torch.Tensor):
        return flat.index_select(-1, torch.as_tensor(index,
                                                     device=flat.device))
    return np.asarray(flat)[..., index]


def flat_from_reference(flat, index: np.ndarray):
    """Inverse of :func:`flat_to_reference`."""
    inverse = np.empty_like(index)
    inverse[index] = np.arange(index.shape[0], dtype=index.dtype)
    return flat_to_reference(flat, inverse)


def encoders_from_reference(schema: Sequence,
                            vgms: Mapping[int, Mapping[str, np.ndarray]],
                            categories: Mapping[int, np.ndarray], *,
                            device: torch.device | str = "cuda"
                            ) -> TableEncoders:
    """``schema`` entries carry ``name/kind/n_categories/max_modes`` (the
    reference's ``ColumnSpec`` will do); ``vgms[j]`` holds column ``j``'s
    ``weights/means/stds/valid`` arrays and ``categories[j]`` its sorted
    raw category ids."""
    dev = resolve_device(device)
    port_schema = [ColumnSpec(c.name, c.kind, c.n_categories, c.max_modes)
                   for c in schema]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)
    params = {j: VGMParams(t(v["weights"]), t(v["means"]), t(v["stds"]),
                           t(v["valid"], torch.bool))
              for j, v in vgms.items()}
    les = {j: LabelEncoder(np.asarray(c)) for j, c in categories.items()}
    return TableEncoders(port_schema, les, params, dev)


def _lm_leaf(flat: Mapping[str, np.ndarray], key: str, index: int | None,
             dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(flat[key], np.float32)
    if index is not None:
        a = a[index]
    return torch.from_numpy(np.array(a, order="C")).to(device, dtype)


# leaves the reference initializes in float32 whatever the model's dtype
_F32_LEAVES = ("gate_i", "gate_f", "gate_o", "slstm_r", "router", "ssm_dt",
               "ssm_dt_bias", "ssm_a", "ssm_d", "xattn_gate")


def _lm_tree(flat: Mapping[str, np.ndarray], prefix: str, cfg: ModelConfig,
             device: torch.device) -> dict:
    """The port's LM parameter dict (or one Adam moment tree) from the
    reference's keys under ``prefix``.  Norm scales, the mLSTM gates, the
    sLSTM recurrent matrix, the MoE router, Mamba's dt, A and D and the
    cross-attention gate are float32, as the reference initializes them;
    every other leaf takes the model's dtype (checkpoints store bfloat16
    as float32)."""
    model_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    keys = [k[len(prefix):] for k in flat if k.startswith(prefix)]
    tree: dict = {}
    for key in keys:
        leaf = key.split("/")[-1]
        dtype = (torch.float32 if leaf.endswith("norm") or leaf in _F32_LEAVES
                 else model_dtype)
        parts = key.split("/")
        if parts[0] == "layers":
            reps = tree.setdefault("layers", [{} for _ in range(cfg.n_rep)])
            for r in range(cfg.n_rep):
                node = reps[r]
                for part in parts[1:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = _lm_leaf(flat, prefix + key, r, dtype,
                                           device)
        else:
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = _lm_leaf(flat, prefix + key, None, dtype,
                                       device)
    return tree


def lm_params_from_reference(flat: Mapping[str, np.ndarray],
                             cfg: ModelConfig, *,
                             device: torch.device | str = "cuda") -> dict:
    """The port's ``Transformer`` parameters from a flattened reference
    parameter tree, every leaf a tensor that requires grad."""
    params = _lm_tree(flat, "", cfg, resolve_device(device))
    for _, t in tree_items(params):
        t.requires_grad_(True)
    return params


def lm_train_state_from_reference(flat: Mapping[str, np.ndarray],
                                  cfg: ModelConfig, *,
                                  device: torch.device | str = "cuda"
                                  ) -> TrainState:
    """The port's ``TrainState`` (parameters, Adam moments in each
    parameter's dtype, as the reference's ``adam`` keeps them by default,
    count, step) from a flattened reference ``TrainState``."""
    dev = resolve_device(device)
    params = lm_params_from_reference(
        {k[len(".params/"):]: v for k, v in flat.items()
         if k.startswith(".params/")}, cfg, device=dev)

    def moments(name):     # keyed, and so ordered, as the parameters
        return tree_leaves(_lm_tree(flat, f".opt_state/.{name}/", cfg, dev))
    opt = AdamState(moments("mu"), moments("nu"),
                    int(np.asarray(flat[".opt_state/.count"])))
    return TrainState(params, opt, int(np.asarray(flat[".step"])))


def lm_caches_from_reference(flat: Mapping[str, np.ndarray],
                             cfg: ModelConfig, *,
                             device: torch.device | str = "cuda") -> list:
    """The port's decode caches (one ``{"pos<i>": ...}`` per repetition)
    from the reference's flattened cache tree: ``KVCache`` (k, v in the
    model's dtype, int32 length), ``MambaState`` (float32 h, bfloat16
    conv_buf), ``MLSTMState`` and ``SLSTMState`` (float32), and a
    cross-attention block's (B,) int32 placeholder, every leaf with a
    leading ``n_rep`` axis."""
    dev = resolve_device(device)
    model_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    kinds = {"attn": (KVCache, {"k": model_dtype, "v": model_dtype,
                                "length": torch.int32}),
             "mamba": (MambaState, {"conv_buf": torch.bfloat16}),
             "mlstm": (MLSTMState, {}), "slstm": (SLSTMState, {})}

    def leaf(key, r, dtype):
        return torch.from_numpy(np.array(flat[key][r], order="C")).to(dev,
                                                                      dtype)
    caches = []
    for r in range(cfg.n_rep):
        rep = {}
        for pos, kind in enumerate(cfg.pattern):
            if kind == "xattn":
                rep[f"pos{pos}"] = leaf(f"pos{pos}", r, torch.int32)
                continue
            state, dtypes = kinds[kind]
            rep[f"pos{pos}"] = state(*(
                leaf(f"pos{pos}/.{f}", r, dtypes.get(f, torch.float32))
                for f in state._fields))
        caches.append(rep)
    return caches
