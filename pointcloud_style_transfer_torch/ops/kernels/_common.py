"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<source>.cu`` has a plain C interface with one or more entry
points. It is compiled with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/<source>-<hash>/lib<source>.so`` at the root of the
checkout (the hash covers the source and the flags, so an edited source builds
anew; a source includes no header of its own, so the hash covers all its code)
and loaded with ``ctypes``; ``utils.cache.enable_compilation_cache`` moves
that directory (``BUILD_ROOT``). Nothing is built on import: the first launch builds
its library, and ``build_all`` builds every library at once, one ``nvcc``
process per source, all started together.

A source's plan constants are ``#define PCST_...`` lines, read by
``source_define`` and overridden at build time with ``-D`` (``build_variants``
builds a source once per set of overrides, for the plan sweeps and tests).

Every wrapper adds one to its kernel's entry of ``LAUNCH_COUNTS`` after each
launch, so a run can show that a path really went through the kernels;
``COUNTED_CALLS`` are calls into PyTorch's kernels counted the same way.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
# utils.cache.enable_compilation_cache may move it
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# csrc/<source>.cu -> {C entry point: its argtypes}
_VP, _INT, _FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "knn_topk": {"pcst_knn_topk": [_VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT,
                                   _INT, _INT, _INT, _INT, _VP]},
    "fps": {"pcst_fps": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT,
                         _INT, _VP]},
    "ball_query": {"pcst_ball_query": [_VP, _VP, _VP, _INT, _INT, _INT, _INT,
                                       _FLT, _VP]},
    "rowmin": {"pcst_rowmin": [_VP, _VP, _VP, _INT, _INT, _INT, _VP]},
    "grid_fused": {
        "pcst_grid_interp": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                             _INT, _INT, _INT, _INT, _INT, _INT, _FLT, _VP],
        "pcst_grid_topk": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT,
                           _INT, _INT, _INT, _VP],
    },
    "knn_packed": {
        "pcst_knn_f32packed": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT,
                               _INT, _INT, _INT, _INT, _VP],
        "pcst_knn_packed": [_VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT,
                            _INT, _VP],
    },
    "knn_pruned": {"pcst_knn_pruned_pass": [_VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                            _INT, _INT, _INT, _INT, _INT,
                                            _VP]},
    "denoiser_block": {"pcst_denoiser_block": [_VP, _VP, _VP, _VP, _VP, _VP,
                                               _INT, _VP]},
}
KERNEL_SOURCES = tuple(SIGNATURES)
# kernel (its LAUNCH_COUNTS key) -> (source, C entry point)
KERNELS = {
    "knn_topk": ("knn_topk", "pcst_knn_topk"),
    "fps": ("fps", "pcst_fps"),
    "ball_query": ("ball_query", "pcst_ball_query"),
    "grid_interp": ("grid_fused", "pcst_grid_interp"),
    "grid_topk": ("grid_fused", "pcst_grid_topk"),
    "rowmin": ("rowmin", "pcst_rowmin"),
    "knn_f32packed": ("knn_packed", "pcst_knn_f32packed"),
    "knn_packed": ("knn_packed", "pcst_knn_packed"),
    "knn_pruned": ("knn_pruned", "pcst_knn_pruned_pass"),
    "denoiser_block": ("denoiser_block", "pcst_denoiser_block"),
}

# kernels that are not built here, counted all the same: "attention", one a
# fused attention call of ``models/transformer.py`` (PyTorch's own kernels)
COUNTED_CALLS = ("attention",)
LAUNCH_COUNTS: Dict[str, int] = {name: 0 for name in (*KERNELS,
                                                     *COUNTED_CALLS)}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def count_launch(name: str) -> None:
    LAUNCH_COUNTS[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from $CUDA_HOME or the toolkit's default
    install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def source_define(name: str, macro: str) -> int:
    """The integer a ``#define <macro> <n>`` line of ``csrc/<name>.cu``
    gives: a plan constant of the source as built without overrides."""
    found = re.search(rf"^#define {macro} (\d+)$",
                      (CSRC / f"{name}.cu").read_text(), re.M)
    if found is None:
        raise KeyError(f"csrc/{name}.cu defines no {macro}")
    return int(found.group(1))


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """Where ``csrc/<name>.cu`` built with ``defines`` (``-D`` flags) goes."""
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join([*NVCC_FLAGS, *defines])
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_ROOT / f"{name}-{digest[:16]}" / f"lib{name}.so"


def _start_build(name: str, defines: Sequence[str] = ()
                 ) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name, defines)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    log = out.with_suffix(".log")
    cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish_builds(pending: dict) -> None:
    """Wait for ``_start_build``'s processes (label -> its triple); raise
    with nvcc's log if any failed."""
    errors = []
    for label, (proc, tmp, out) in pending.items():
        if proc.wait() != 0:
            errors.append(f"{label}:\n{out.with_suffix('.log').read_text()}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed for " + "\n".join(errors))


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Build every missing library in parallel; returns name -> .so path.
    Raises with nvcc's log if any build fails."""
    _finish_builds({n: _start_build(n) for n in names
                    if not library_path(n).exists()})
    return {n: library_path(n) for n in names}


def build_variants(name: str, variants: dict) -> dict:
    """``csrc/<name>.cu`` built once per variant (label -> its ``-D``
    flags), one ``nvcc`` each, all started together -> label: loaded
    library, for ``launching``."""
    _finish_builds({label: _start_build(name, flags)
                    for label, flags in variants.items()
                    if not library_path(name, flags).exists()})
    return {label: open_library(library_path(name, flags), name)
            for label, flags in variants.items()}


def open_library(path: Path, name: str) -> ctypes.CDLL:
    """A built library of ``csrc/<name>.cu`` at ``path``, loaded, with its
    entry points' argtypes declared."""
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pcst_error_string.argtypes = [ctypes.c_int]
    lib.pcst_error_string.restype = ctypes.c_char_p
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = open_library(build_all([name])[name], name)
        return _libs[name]


@contextlib.contextmanager
def launching(name: str, lib: ctypes.CDLL):
    """Within the block the wrappers of ``csrc/<name>.cu`` launch ``lib``
    (a ``build_variants`` library) instead of the source's own build."""
    own = load_library(name)
    _libs[name] = lib
    try:
        yield
    finally:
        _libs[name] = own


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s entry point on ``device``'s current stream
    (appended as the last argument), raise on a launch error, count it."""
    source, fn_name = KERNELS[name]
    lib = load_library(source)
    fn = getattr(lib, fn_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        msg = lib.pcst_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")
    count_launch(name)


def check_points(x: torch.Tensor, what: str) -> None:
    """A kernel input: a contiguous float32 [B, N, 3] CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{what} must be float32, got {x.dtype}")
    if x.dim() != 3 or x.shape[-1] != 3:
        raise ValueError(f"{what} must be [B, N, 3], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def pairwise_sq_dist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """[..., S, 3] x [..., N, 3] -> [..., S, N] squared distances in the
    kernels' form, (dx*dx + dy*dy) + dz*dz with each op rounded on its own —
    the same bits the CUDA kernels produce. (XLA on the CPU contracts the TPU
    kernels' form into FMAs, so the JAX package's interpret-mode kernels
    differ from it in the last bit on some pairs.)"""
    dx = q[..., :, None, 0] - r[..., None, :, 0]
    dy = q[..., :, None, 1] - r[..., None, :, 1]
    dz = q[..., :, None, 2] - r[..., None, :, 2]
    return (dx * dx + dy * dy) + dz * dz
