"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
in parallel, and linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library is named by the sha256 of the sources
and the flags (``_build/libmct_kernels-<digest>.so``), so an edit rebuilds
and an unchanged tree reuses the cached file. Objects and the linked library
go to a private work directory, and the library is renamed into place
atomically, so concurrent builders never load a half-written file. A failed
build raises: there is no fallback.

The build happens on the first call of ``load()``, which only the kernel
wrappers make when they are handed a CUDA tensor — importing this module
compiles nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).with_name("csrc")
_BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the exported functions (csrc/*.cu), all returning an int:
# each launcher the cudaError_t of its launches, the two pass-1 queries the
# fused kernel's shared-memory bytes for a tile and its budget, the
# depthwise query its shared-memory bytes for a band and strip.
_SIGNATURES = {
    "mct_patch_crop": [
        _P, _I, _I, _P, _I, _I, _I,      # image, h, w, starts, n_points, ps, pad
        _F, _F, _F, _F, _F, _F,          # scale[3], bias[3]
        _P, _I, _P,                      # out, out_bf16, stream
    ],
    "mct_fused_mbconv": [
        _P, _P, _I,                      # x, out, act_bf16
        _I, _I, _I, _I, _I, _I, _I, _I,  # n, h, w, cin, cmid, cout, cse, k
        _I,                              # residual
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # weights and biases
        _P, _P, _P,                      # d scratch, partial sums, SE scale
        _I, _P,                          # rows per tile, stream
    ],
    "mct_fused_pass1_smem_bytes": [
        _I, _I, _I, _I, _I,              # act_bf16, rows, w, cin, k
    ],
    "mct_fused_pass1_smem_budget": [],
    "mct_depthwise": [
        _P, _P, _I, _I,                  # x, out, act_bf16, vec_loads
        _I, _I, _I, _I, _I,              # n, h, w, c, k
        _P, _P,                          # taps (k, k, c), bias (c,)
        _I, _I, _P,                      # band rows, strip rows, stream
    ],
    "mct_depthwise_smem_bytes": [
        _I, _I, _I, _I, _I,              # act_bf16, band, strip, w, k
    ],
}

_lib: ctypes.CDLL | None = None
last_build_log = ""


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels"
        " cannot be built"
    )


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libmct_kernels-{digest.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands at once (one nvcc each); log them all, raise if any
    failed."""
    global last_build_log
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    last_build_log += "".join(logs)
    failed = [(cmd, proc.returncode, log)
              for cmd, proc, log in zip(cmds, procs, logs) if proc.returncode]
    if failed:
        cmd, rc, log = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}) on {cmd[-1]}:\n{log[-4000:]}")


def build() -> Path:
    """Compile the kernels if the library for the current sources is
    missing; returns its path. Every ``.cu`` file is compiled by its own
    nvcc, all started together, and the objects are linked into one library.
    Raises RuntimeError when nvcc fails."""
    global last_build_log
    lib = library_path()
    if lib.is_file():
        return lib
    last_build_log = ""
    work = _BUILD_DIR / f".{lib.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        nvcc = _nvcc()
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        units = [s for s in _sources() if s.suffix == ".cu"]
        objs = [work / f"{src.stem}.o" for src in units]
        _run([[nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(units, objs)])
        tmp = work / lib.name
        _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *map(str, objs)]])
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mct_error_string.argtypes = [_I]
        lib.mct_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        name = load().mct_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({name})")
