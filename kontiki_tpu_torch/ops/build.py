"""Build and bind the port's CUDA kernels.

The sources under ``kontiki_tpu_torch/csrc`` are compiled with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface, bound
with ``ctypes``. The library is built at first use into
``kontiki_tpu_torch/_build`` (git-ignored) under a name keyed by a hash of
the sources and flags, so a changed source is rebuilt and an unchanged one
is loaded as it is.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name -> argument types (every entry returns cudaError_t)
_ENTRIES = {
    "kontiki_linearize_rows": [_P] * 12 + [_P, _P, _P, _I, _P],
    "kontiki_assemble_schur": [_P] * 10 + [_I] * 6 + [_P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def library_path():
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"kontiki_kernels_{h.hexdigest()[:16]}.so"


def build():
    """Compile the kernels if the library for these sources is missing.
    Returns its path; the compiler's report is kept beside it (``.log``)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: concurrent builds race safely
    return so


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load the kernels; returns the ``ctypes`` handle
    with ``argtypes``/``restype`` set for every ``_f32``/``_f64`` entry."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _ENTRIES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
