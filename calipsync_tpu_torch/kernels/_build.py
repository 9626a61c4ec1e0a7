"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Every ``csrc/*.cu`` compiles to an object file for ``sm_90a``, all of them
at once (one nvcc process per source), and the objects link into one
shared library with a plain C interface, ``build/libcalipsync_kernels.so``
beside this file. The build runs at first use and again whenever a source
is newer than the library; nothing is built when a module is imported.
Each C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` turns a non-zero status into an exception.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
import time

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
LIB_NAME = "libcalipsync_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

# dtype codes of csrc/common.cuh
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def nvcc_path() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    home = os.environ.get("CUDA_HOME")
    if home:
        candidates.insert(0, os.path.join(home, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(force: bool = False,
          defines: tuple[str, ...] = ()) -> tuple[pathlib.Path, float]:
    """Compile and link the kernels if the library is missing or stale.
    Returns (library path, seconds spent building; 0.0 when up to date).
    ``defines`` (``-D`` macros) build another library beside the main one,
    named after them, as ``kernels/bench.py`` does for its bisect variants.
    The compiler's output, register and shared-memory use included, goes
    to ``build/nvcc.log`` (``build/<library>.nvcc.log`` for another
    library)."""
    lib_name = LIB_NAME.replace(
        ".so", "".join(f".{d.lower()}" for d in defines) + ".so")
    sources = sorted(CSRC.glob("*.cu"))
    inputs = sources + sorted(CSRC.glob("*.cuh"))
    lib = BUILD_DIR / lib_name
    newest = max(p.stat().st_mtime for p in inputs)
    if not force and lib.exists() and lib.stat().st_mtime >= newest:
        return lib, 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    procs = [subprocess.Popen([nvcc, *flags, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    logs, failed = [], []
    for s, p in zip(sources, procs):
        out, _ = p.communicate()
        logs.append(f"== {s.name}\n{out}")
        if p.returncode:
            failed.append(s.name)
    log_name = "nvcc.log" if lib_name == LIB_NAME else f"{lib_name}.nvcc.log"
    (BUILD_DIR / log_name).write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"{lib_name}.{tag}"
    link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                           "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    for o in objs:
        o.unlink()
    return lib, time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = build()
            _LIB = ctypes.CDLL(str(path))
        return _LIB


def function(name: str, argtypes: list, restype=ctypes.c_int):
    """One C entry point of the library with its argument types declared
    (pointers and the stream as c_void_p, so ctypes does not cut them to
    32 bits)."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                           f"{status}")


def dtype_code(dtype) -> int:
    try:
        return DTYPE_CODES[str(dtype)]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not "
                        f"{dtype}") from None
