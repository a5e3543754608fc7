"""Build the hand-written CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into a plain-C shared library
under ``pygradflow_torch/_build/<hash>/``, where the hash covers the sources
and the flags, so an edited kernel is rebuilt and an unchanged one is
reused.  A missing ``nvcc`` or a failed build raises: there is no fallback.
Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB = None
BUILD_SECONDS = None
"""Wall seconds of the build (or of finding it built) in this process."""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of pygradflow_torch are built "
            "at first use and need the CUDA toolkit"
        )
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libpgf_kernels.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; return its path.
    The compiler's report (registers, spills) lands in ``build.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (lib.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB, BUILD_SECONDS
    if _LIB is None:
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(build()))
        for name in ("pgf_ldlt_factor_rl", "pgf_ldlt_factor_ll"):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        lib.pgf_ldlt_panel_widths.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)
        ]
        lib.pgf_ldlt_panel_widths.restype = ctypes.c_int
        BUILD_SECONDS = time.perf_counter() - t0
        _LIB = lib
    return _LIB
