"""Hand-written CUDA kernels of the port: build with nvcc, load with ctypes.

Each ``<name>.cu`` beside this file (``wide_trace``, ``binary_trace``,
``bruteforce``) is compiled on first use into its own
``_build/lib<name>.so`` (git-ignored) for ``sm_90a`` and loaded with
ctypes; pointers and the stream are passed as ``c_void_p``. A failed
build raises. Nothing is compiled when the module is imported.

    python -m cadrays_tpu_torch.kernels.build      # rebuild all, print ptxas
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel name -> (C entry point, its argument types)
KERNELS = {
    "wide_trace": ("crt_wide_trace", [_P] * 11 + [_I] * 5 + [_P] * 5),
    "binary_trace": ("crt_binary_trace", [_P] * 5 + [_I, _I] + [_P] * 5),
    "bruteforce": ("crt_bruteforce", [_P] * 4 + [_I, _I] + [_P] * 2),
}

_locks = {name: threading.Lock() for name in KERNELS}
_loaded = {}  # name -> (ctypes.CDLL, ptxas text of the build in this process)


def _nvcc() -> str:
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda, "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def load(name: str, force: bool = False):
    """(library, ptxas text) of ``<name>.cu``.

    Builds the library first when it is missing, older than its source,
    or ``force`` is set; the ptxas text is "" when nothing was built.
    Different kernels build concurrently from different threads.
    """
    entry, argtypes = KERNELS[name]
    src = os.path.join(_DIR, f"{name}.cu")
    lib_path = os.path.join(BUILD_DIR, f"lib{name}.so")
    with _locks[name]:
        if name in _loaded and not force:
            return _loaded[name]
        ptxas = ""
        if force or not (os.path.exists(lib_path) and
                         os.path.getmtime(lib_path) >= os.path.getmtime(src)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True,
                               timeout=600)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {name}.cu "
                                   f"(exit {r.returncode}):\n"
                                   f"{r.stdout[-4000:]}")
            os.replace(tmp, lib_path)
            ptxas = r.stdout
        lib = ctypes.CDLL(lib_path)
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = (lib, ptxas)
        return _loaded[name]


if __name__ == "__main__":
    for _name in KERNELS:
        print(_name, load(_name, force=True)[1], sep="\n")
