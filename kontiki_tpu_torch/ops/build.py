"""Build and bind the port's CUDA kernels.

The sources under ``kontiki_tpu_torch/csrc`` are compiled with ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per ``.cu`` file, all started together,
and linked into one shared library with a plain C interface, bound with
``ctypes``. The library is built at first use into
``kontiki_tpu_torch/_build`` (git-ignored) under a name keyed by a hash of
the sources and flags, so a changed source is rebuilt and an unchanged one
is loaded as it is.

``build_host`` compiles host sources with a plain C++ compiler: the
kernels' per-row code (``csrc/host_rows.cpp``: the row math on ``double``
for checks without a card, and on an operation-counting scalar for the
operation side of a kernel's bound), and the problem compiler's native
helper (``csrc/kontiki_host.cpp``, bound by ``kontiki_tpu_torch.native``).
"""
import contextlib
import ctypes
import fcntl
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
#: C entry points: name -> argument types (every entry returns cudaError_t)
_ENTRIES = {
    "kontiki_linearize_rows": [_P, _P, _P, _P, _I, _I, _P],
    "kontiki_cost_rows": [_P, _P, _I, _I, _P],
    "kontiki_cost_rows_wave": [_I],
    "kontiki_assemble_schur": [_P] * 10 + [_I] * 6 + [_P, _P],
    "kontiki_imu_rows": [_P] * 10 + [_P, _P, _I, _I, _P],
    "kontiki_eval_windows": [_I, _P, _P, _D, _P, _I, _P],
    "kontiki_r3_evaluate": [_P, _I, _D, _D, _P, _P, _P, _P, _I, _P],
    "kontiki_onehot_expand": [_P, _P, _P, _I, _I, _I, _I, _P],
    "kontiki_newton_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "kontiki_newton_rows_wave": [_I, _I, _I],
    "kontiki_newton_rows_smem": [_I, _I, _I],
}
#: -O1: the row code runs as fast as at -O2 (the checks and operation counts
#: are bound by the counting scalar's bookkeeping) and compiles in ~60% of
#: the time, which the test workers that need the library wait for
HOST_FLAGS = ("-std=c++17", "-O1", "-shared", "-fPIC")
#: host entry points: name -> (argument types, return type)
_HOST_ENTRIES = {
    "kontiki_host_imu_rows_f64": ([_P, _P, _P, _I, _I, _I], None),
    "kontiki_count_imu_rows": ([_P, _I, _I], ctypes.c_longlong),
    "kontiki_host_linearize_rows_f64": ([_P, _P, _P, _P, _I, _I, _I], None),
    "kontiki_count_linearize_rows": ([_P, _I, _I], ctypes.c_longlong),
    "kontiki_host_cost_rows_f64": ([_P, _P, _I, _I, _I], None),
    "kontiki_count_cost_rows": ([_P, _I, _I], ctypes.c_longlong),
    "kontiki_host_eval_windows_f64": ([_I, _P, _P, _D, _P, _I], None),
    "kontiki_count_eval_windows": ([_I, _P, _P, _D, _I], ctypes.c_longlong),
    "kontiki_host_r3_evaluate_f64": ([_P, _I, _D, _D, _P, _P, _P, _P, _I], None),
    "kontiki_count_r3_evaluate": ([_P, _I, _D, _D, _P, _I], ctypes.c_longlong),
    "kontiki_host_assemble_schur_f64": ([_P] * 10 + [_I] * 9, None),
    "kontiki_host_newton_rows_f64": ([_P] * 6 + [_I] * 5, None),
    "kontiki_count_newton_rows": ([_P] + [_I] * 4, ctypes.c_longlong),
    "kontiki_host_newton_paths_f64": ([_P, _P] + [_I] * 4, None),
    "kontiki_newton_local_w": ([], ctypes.c_int),
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def _library_path(stem, flags, sources):
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path():
    """Path of the shared library for the current sources and flags."""
    return _library_path("kontiki_kernels", NVCC_FLAGS, _sources())


def _compile(so, cmd):
    """Run ``cmd -o <tmp>`` and move the result to ``so`` (atomic, so
    concurrent builds race safely); the report is added to ``so``'s
    ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".so.tmp{os.getpid()}")
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True)
    with open(so.with_suffix(".log"), "a") as log:
        log.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{cmd[0]} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


@contextlib.contextmanager
def _locked(so):
    """Hold an exclusive lock on ``so``'s ``.lock`` file in the build
    directory, so that concurrent processes (pytest workers) build a library
    once and the others wait for it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build():
    """Compile the kernels if the library for these sources is missing:
    each ``.cu`` to an object in parallel, then one link. Returns the
    library's path; the compilers' reports are kept beside it (``.log``)."""
    so = library_path()
    if so.exists():
        return so
    with _locked(so):
        return so if so.exists() else _build(so)


def _build(so):
    tag = f"{so.stem}.{os.getpid()}"
    jobs = []
    for cu in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{cu.stem}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)]
        jobs.append((cu, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cu, _, proc in jobs:
        log.append(f"== {cu.name}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(cu.name)
    so.with_suffix(".log").write_text("\n".join(log))
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        return _compile(so, [_nvcc(), "-shared", *NVCC_FLAGS[:2], *objs])
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)


#: host sources: file in ``csrc`` -> (library stem, whether it includes
#: the ``.cu`` sources, whose text then keys the library's name too)
HOST_SOURCES = {
    "host_rows.cpp": ("kontiki_host", True),  # the kernels' row code
    "kontiki_host.cpp": ("kontiki_native", False),  # the problem compiler's helper
}


def build_host(source="host_rows.cpp"):
    """Compile a host source of ``csrc`` (``HOST_SOURCES``) with the host
    C++ compiler if needed; returns the library's path."""
    stem, includes_cu = HOST_SOURCES[source]
    src = CSRC / source
    so = _library_path(stem, HOST_FLAGS, [src, *(_sources() if includes_cu else ())])
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("c++") or "g++"
    with _locked(so):
        return so if so.exists() else _compile(so, [cxx, *HOST_FLAGS, str(src)])


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load the kernels; returns the ``ctypes`` handle
    with ``argtypes``/``restype`` set for every ``_f32``/``_f64`` entry."""
    return bind_library(build())


def bind_library(path):
    """Load a library of the kernels' C entry points from ``path`` and set
    the ``argtypes``/``restype`` of every ``_f32``/``_f64`` entry it has (a
    library built from an older checkout's sources may lack newer ones)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ENTRIES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix, None)
            if fn is None:
                continue
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    for suffix in ("_f32", "_f64"):
        fn = getattr(lib, "kontiki_assemble_schur_workspace" + suffix, None)
        if fn is not None:
            fn.argtypes = [_I] * 4
            fn.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def load_host_library():
    """Build (if needed) and load ``csrc/host_rows.cpp``'s library."""
    return bind_host_library(build_host())


def bind_host_library(path):
    """Load a library of the host row code from ``path`` and bind the
    entries it has, as ``bind_library`` does."""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _HOST_ENTRIES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = restype
    return lib
