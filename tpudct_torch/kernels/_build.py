"""Build and load the CUDA library of the hp kernels.

``tpudct_torch/csrc/hp_codec.cu`` (kernels B1-B7) is compiled by nvcc into a shared library
with a plain C interface and loaded with ctypes.  The library lives in
``build/tpudct_torch/`` at the root of the checkout (listed in .gitignore),
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one loads at once.  Nothing is built at import: the first
kernel launch builds.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "hp_codec.cu"
BUILD_DIR = _PKG.parent / "build" / "tpudct_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argument types; every function returns a cudaError_t as int.
_SIGNATURES = {
    "hp_rt_u8_launch": (_P, _P, _P, _I, _I, _P, _P, _I),
    "hp_encode_u8_launch": (_P, _P, _I, _I, _P, _P, _I),
    "hp_decode_u8_launch": (_P, _P, _I, _I, _P, _P, _I),
    "hp_rt_f32_launch": (_P, _P, _P, _I, _I, _I, _P, _P, _I),
    "hp_dct_launch": (_P, _P, _I, _I, _I, _P, _P, _I),
    "hp_idct_launch": (_P, _P, _I, _I, _P, _P, _I),
    "hp_scaled_decode_u8_launch": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _I),
}


def nvcc_path() -> str:
    """nvcc from PATH, else from the CUDA toolkit PyTorch found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the hp CUDA kernels need the CUDA toolkit")


def library_path() -> pathlib.Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libhp_codec-{key}.so"


def build() -> pathlib.Path:
    """Compile the library unless this source's build exists; return its path.

    The compiler's output (``-Xptxas -v``: registers, stack, spills per
    kernel) is kept beside the library as ``<name>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE.name}:\n{proc.stderr}"
            )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def build_log() -> str:
    """nvcc's output for the current library (builds it if needed)."""
    return build().with_suffix(".log").read_text()


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library, with argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.hp_error_string.argtypes = [ctypes.c_int]
    lib.hp_error_string.restype = ctypes.c_char_p
    return lib
