"""The port's public surface equals the JAX package's, module by module.

For every module file of ``src/repro/``, both twins are read with ``ast``
(neither is imported): every public top-level name of the reference must
be defined or re-exported by ``src/repro_torch/``'s file of the same path.
"Public" means a function, class or assigned name that does not start with
``_``, plus, in an ``__init__.py``, every name imported with ``from``.
The port's file counts what it defines, assigns or imports, its
``__all__``, and, where it has a module ``__getattr__``, the names of its
top-level string tuples (its lazy exports).  The names the port carries
by intent in another form are the one allowlist below, each with its
reason.  Neither package is imported.
"""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REFERENCE = SRC / "repro"
PORT = SRC / "repro_torch"

# (module path under the package, name): ported by intent, no twin needed
PORTED_BY_INTENT = {
    # the JAX pytree type aliases; the port's trees are torch tensors and
    # modules, typed as such
    ("core/aggregation.py", "PyTree"),
    ("core/fedavg.py", "PyTree"),
    ("fed/merge.py", "PyTree"),
    ("models/layers.py", "PyTree"),
    ("models/model.py", "PyTree"),
    ("optim/optimizers.py", "PyTree"),
    # the functional forwards of the reference's parameter trees are the
    # ``forward`` of the port's Generator and Discriminator modules
    ("gan/ctgan.py", "generator_forward"),
    ("gan/ctgan.py", "discriminator_forward"),
    # the per-leaf tree merge: the port merges the flattened stack
    # (``ops.weighted_average_flat``, ``fed/merge.py``)
    ("kernels/ops.py", "weighted_average_tree"),
    # the Pallas modules' entry points and their masking constant: the
    # port reaches each kernel through ``kernels/ops.py`` (its CUDA
    # wrapper is ``<name>_cuda``), and NEG_INF lives in ``kernels/ref.py``
    ("kernels/flash_attention.py", "flash_attention"),
    ("kernels/flash_attention.py", "NEG_INF"),
    ("kernels/mlstm_chunk.py", "mlstm_chunk"),
    ("kernels/mlstm_chunk.py", "NEG_INF"),
    ("kernels/segment_activations.py", "segment_activations"),
    ("kernels/segment_activations.py", "segment_activations_packed"),
    ("kernels/vgm_decode.py", "vgm_decode_table"),
    ("kernels/vgm_encode.py", "vgm_encode"),
    ("kernels/vgm_encode.py", "vgm_encode_table"),
    ("kernels/weighted_agg.py", "weighted_agg"),
    # the XLA HLO cost reader and the TPU's inter-chip bandwidth: the port
    # counts a step with ``counting.OpCounter`` (``count_ops``) against
    # the H100's peaks
    ("launch/roofline.py", "analyze_hlo"),
    ("launch/roofline.py", "ICI_BW"),
}

MODULES = sorted(str(p.relative_to(REFERENCE))
                 for p in REFERENCE.rglob("*.py"))


def _top_level(body):
    """Statements at module level, through ``if`` and ``try`` blocks."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _top_level(node.body)
            yield from _top_level(node.orelse)
            for handler in getattr(node, "handlers", []):
                yield from _top_level(handler.body)
            yield from _top_level(getattr(node, "finalbody", []))
        else:
            yield node


def _assigned(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in targets:
        for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
            if isinstance(e, ast.Name):
                yield e.id


def _strings(value):
    if isinstance(value, (ast.Tuple, ast.List)):
        return [e.value for e in value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return []


def reference_names(path: Path) -> set:
    """The public names the reference's module offers."""
    names = set()
    for node in _top_level(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names.update(_assigned(node))
        elif (path.name == "__init__.py" and isinstance(node, ast.ImportFrom)
              and node.module != "__future__"):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def port_names(path: Path) -> set:
    """Every name the port's module binds or exports."""
    names, lazy = set(), []
    for node in _top_level(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            bound = list(_assigned(node))
            names.update(bound)
            if node.value is not None:
                strings = _strings(node.value)
                if "__all__" in bound:
                    names.update(strings)
                lazy += strings
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    if "__getattr__" in names:
        names.update(lazy)
    return names


def test_every_reference_module_is_checked():
    assert len(MODULES) >= 80
    assert "tabular/vgm.py" in MODULES and "launch/__init__.py" in MODULES
    stale = {m for m, _ in PORTED_BY_INTENT} - set(MODULES)
    assert not stale, stale


@pytest.mark.parametrize("module", MODULES)
def test_port_offers_the_reference_public_names(module):
    twin = PORT / module
    assert twin.is_file(), f"src/repro_torch/{module} is missing"
    allowed = {n for m, n in PORTED_BY_INTENT if m == module}
    ref = reference_names(REFERENCE / module)
    missing = sorted(ref - port_names(twin) - allowed)
    assert not missing, (f"src/repro_torch/{module} lacks the reference's "
                         f"{missing}")
    # an allowlisted name the reference no longer has is stale
    assert allowed <= ref, sorted(allowed - ref)
