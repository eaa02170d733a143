"""Build, load and launch the hand-written CUDA kernels.

Each ``csrc/<stem>.cu`` exposes a plain C interface.  At first use every
source is compiled by ``nvcc`` for ``sm_90a`` into
``<repo>/build/repro_torch/<stem>-<hash>.so`` (one ``nvcc`` per source, all
started together), where the hash covers the source and the flags, and
the library is loaded with :mod:`ctypes`.  Nothing is compiled when this
module is imported.  A failed build or launch raises; there is no fallback
to the plain PyTorch versions.

``DISPATCH_COUNTS`` counts, per kernel name, the launches that returned
without error; :mod:`repro_torch.kernels.ops` adds the ``<name>_ref`` keys
of the CPU route to the same counter.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("vgm_encode", "vgm_decode", "segment_activations",
           "weighted_agg", "flash_attention", "flash_attention_sm90",
           "mlstm_chunk_sm90")
# --fmad=false: no contraction into fused multiply-adds, so each kernel
# rounds like its plain version; no --use_fast_math: IEEE expf/logf/tanhf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

DISPATCH_COUNTS: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def _target(stem: str) -> Path:
    # the hash covers the shared headers too, which any source may include
    parts = [CSRC / f"{stem}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{digest}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are compiled with the CUDA toolkit at first use")
    return path


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel.
    Returns the wall seconds spent (0.0 when everything was built)."""
    with _LOCK:
        todo = {s: _target(s) for s in SOURCES if not _target(s).exists()}
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for stem, so in todo.items():
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            with open(so.with_suffix(".log"), "w") as log:
                procs[stem] = (subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")],
                    stdout=log, stderr=subprocess.STDOUT), tmp, so)
        failed = []
        for stem, (proc, tmp, so) in procs.items():
            if proc.wait() == 0:
                os.replace(tmp, so)
            else:
                failed.append(f"{stem}:\n{so.with_suffix('.log').read_text()}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return time.perf_counter() - t0


def library_path(stem: str) -> Path:
    """The shared library ``csrc/<stem>.cu`` builds into in this tree."""
    return _target(stem)


def build_log(stem: str) -> str:
    """The compiler's output (ptxas register and shared-memory report) of
    the last build of ``stem`` in this tree."""
    path = _target(stem).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def kernel_function(stem: str, name: str, argtypes: list,
                    restype=ctypes.c_int):
    """The C function ``name`` of ``csrc/<stem>.cu``, building the
    libraries first if needed (looked up once, then cached)."""
    fn = _FNS.get((stem, name))
    if fn is not None:
        return fn
    lib = _LIBS.get(stem)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(stem)))
        err = getattr(lib, f"{stem}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _LIBS[stem] = lib
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, restype
    _FNS[(stem, name)] = fn
    return fn


def check_cuda_inputs(name: str, device: torch.device, *,
                      dtype: torch.dtype = torch.float32, **tensors) -> None:
    """Raise unless every ``tensors[k] = (tensor, shape)`` is a contiguous
    CUDA tensor of ``dtype`` and that shape on ``device`` that needs no
    grad.  Every wrapper launches one kernel and records no autograd graph;
    the backwards of ``segment_activations`` and ``flash_attention`` are
    reached through their ``autograd.Function``s."""
    if device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{device}")
    for arg, (t, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.requires_grad:
            raise RuntimeError(
                f"{name}: {arg} requires grad, but the kernel wrappers record "
                "no autograd graph: the encode, decode, merge and mlstm_chunk "
                "kernels have no backward, and segment_activations and "
                "flash_attention take theirs through ops.segment_activations "
                "and ops.flash_attention")


def launch(name: str, stem: str, fn, device: torch.device, *args) -> None:
    """Call a kernel's C entry on the current stream of ``device``; raise
    on a refused launch, else count it in ``DISPATCH_COUNTS[name]``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = getattr(_LIBS[stem], f"{stem}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
    DISPATCH_COUNTS[name] += 1
