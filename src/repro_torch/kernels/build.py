"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Libraries go to ``build/repro_torch_kernels/`` at the root
of the checkout, named by a hash of their source and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  Nothing is built
when this module is imported: :func:`library` builds on first use, and
:func:`build_all` builds every source at once, one ``nvcc`` process each,
all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("fwht", "saddle_update")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every exported C function, by library
SIGNATURES = {
    "fwht": {
        "fwht_rows_f32": [_P, _P, ctypes.c_longlong, _I, _I, _I,
                          ctypes.c_float, _P],
        "fwht_strided_f32": [_P, ctypes.c_longlong, _I, _I, ctypes.c_float,
                             _P],
    },
    "saddle_update": {
        "momentum_dot_packed_f32": [_P] * 9 + [_I] * 5 + [_P],
        "mwu_update_packed_f32": [_P] * 8 + [ctypes.c_float] + [_P] * 5
                                 + [_I] * 5 + [_P],
        "momentum_dot_f32": [_P, _P, _P, ctypes.c_float, _P, _P, _P]
                            + [_I] * 6 + [_P],
        "mwu_update_f32": [_P] * 4 + [ctypes.c_float] * 4 + [_I]
                          + [_P] * 5 + [_I] * 6 + [_P],
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, else ``PATH``, else /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def _start(name: str) -> tuple[Path, subprocess.Popen | None]:
    """Start the nvcc build of one source (None if already built)."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc


def _finish(name: str, out: Path, proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)          # atomic: a reader never sees half a file
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def build_all() -> dict[str, str]:
    """Build every source in parallel; returns nvcc's output by source
    (empty for a library that was already built)."""
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        return {name: _finish(name, *started[name]) for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed, with
    every exported function's argtypes and restype set."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            out, proc = _start(name)
            _finish(name, out, proc)
            lib = ctypes.CDLL(str(out))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
