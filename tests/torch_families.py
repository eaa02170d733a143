"""Shared set-up of the model-family parity tests
(``tests/test_torch_families*.py``, ``tests/test_torch_launch_families.py``):
the smoke configs of the five families that need the MoE FFN, Mamba,
cross-attention or frame inputs, in float32, the reference's initial
parameters with every cross-attention gate set to 0.7 (at its initial 0,
``tanh`` switches cross-attention off and a parity test would prove
nothing about it), carried across by ``repro_torch.interop``, and
numpy-seeded inputs for both packages."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.checkpoint import _flatten
from repro.configs import get_smoke_config as jget_smoke
from repro.models import Transformer as JTransformer
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.models import Transformer, tree_items

FAMILIES = ["mixtral-8x22b", "llama4-maverick-400b-a17b",
            "jamba-1.5-large-398b", "llama-3.2-vision-11b", "hubert-xlarge"]
CPU = torch.device("cpu")
GATE = 0.7


def cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def jcfg(arch, **kw):
    return dataclasses.replace(jget_smoke(arch), dtype="float32", **kw)


def _with_gates(tree):
    if isinstance(tree, dict):
        return {k: (jnp.full_like(v, GATE) if k == "xattn_gate"
                    else _with_gates(v)) for k, v in tree.items()}
    return tree


@functools.lru_cache(maxsize=None)
def reference(arch, seed=0, **kw):
    """The reference model and its parameters, gates at 0.7."""
    model = JTransformer(jcfg(arch, **kw))
    return model, _with_gates(model.init(jax.random.PRNGKey(seed)))


def port(arch, seed=0, **kw):
    """The port's model and a fresh copy of the reference's parameters."""
    _, jparams = reference(arch, seed, **kw)
    c = cfg(arch, **kw)
    return Transformer(c), interop.lm_params_from_reference(
        _flatten(jparams), c, device=CPU)


def inputs(arch, seed, B, S, **kw):
    """Numpy inputs of one batch: tokens (the labels), and the frame
    features or vision embeddings the config reads."""
    c = cfg(arch, **kw)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, c.vocab, (B, S), dtype=np.int32)}
    if not c.embed_inputs:
        out["features"] = rng.normal(size=(B, S, c.d_model)).astype(
            np.float32)
    if c.xattn_tokens:
        out["vision"] = rng.normal(size=(B, c.xattn_tokens, c.d_model)
                                   ).astype(np.float32)
    return out


def batches(arch, arrays, **kw):
    """(the reference's batch, the port's batch) of ``arrays``."""
    c = cfg(arch, **kw)
    jb = {"labels": jnp.asarray(arrays["tokens"])}
    tb = {"labels": torch.from_numpy(arrays["tokens"]).long()}
    for name in ("features", "vision"):
        if name in arrays:
            jb[name] = jnp.asarray(arrays[name])
            tb[name] = torch.from_numpy(arrays[name])
    if c.embed_inputs:
        jb["tokens"] = jnp.asarray(arrays["tokens"])
        tb["tokens"] = torch.from_numpy(arrays["tokens"]).long()
    return jb, tb


def as_reference(params) -> dict:
    """The port's parameters keyed as the reference's flattened tree, the
    per-layer leaves stacked on a leading axis."""
    out: dict = {}
    for path, t in tree_items(params):
        parts = path.split("/")
        if parts[0] == "layers":
            out.setdefault("/".join(["layers"] + parts[2:]), []).append(
                t.detach().float().numpy())
        else:
            out[path] = t.detach().float().numpy()
    return {k: np.stack(v) if isinstance(v, list) else v
            for k, v in out.items()}
