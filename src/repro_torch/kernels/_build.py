"""Build the CUDA sources of ``kernels/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, placed under
``build/repro_torch/`` at the root of the checkout and named by a hash of its
source and the shared headers, so an edited source is rebuilt and an
unchanged one is reused. Only sources in the repository are built; a failed
build raises.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("rmsnorm", "flash_attention", "decode_attention", "ssd_scan", "ssm_step")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> Tuple[Path, Path]:
    """Source and library path; the name hashes the source and its headers."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when the library is built."""
    src, lib = _target(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, lib


def _finish(name: str, job) -> str:
    proc, tmp, lib = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)  # atomic: a reader never sees half a library
    lib.with_suffix(".log").write_text(out)
    return out


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile the named sources in parallel, one ``nvcc`` each.

    Returns the compiler's report (``-Xptxas -v``: registers, shared memory
    and spills) for each source built by this call.
    """
    names = list(names)
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, job) for n, job in jobs.items() if job is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)[1]))
            lib.repro_cuda_error_string.argtypes = [I]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point with its argument types set (pointers as c_void_p)."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = I
    return fn


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = load(name).repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")


def stream() -> int:
    """Handle of PyTorch's current CUDA stream, for the C entry points."""
    return torch.cuda.current_stream().cuda_stream
