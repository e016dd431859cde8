"""Build and load the CUDA library of the port's kernels.

``tpudct_torch/csrc/hp_codec.cu`` (kernels B1-B6, B3 with a forward
pointer as B15), ``tpudct_torch/csrc/hp_inverse.cu`` (B7 and the study's
split3 inverse B22),
``tpudct_torch/csrc/color_codec.cu`` (B8-B13 and the study variants B23,
B26), ``tpudct_torch/csrc/ring.cu`` (B14, B16) and
``tpudct_torch/csrc/study.cu`` (the study kernels B17-B20, B30, B31) are compiled by
nvcc, one process per source, all started together, and linked into one
shared library with a plain C
interface, loaded with ctypes; :func:`call` launches one of its functions.
The library lives in ``build/tpudct_torch/`` at the root of the checkout
(listed in .gitignore), named by a hash of the flags, the sources and the
headers they share (``csrc/*.cuh``: the 8x8 block chains, the color pixel
chains, the 4:2:0 strip body of B16 and B20, and ``copy.cuh``, the one copy
body of B14 and B17/B18), so an edited source or header rebuilds the
library and an unchanged one loads at once.  Nothing is built at import: the first kernel
launch builds.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCES = tuple(_PKG / "csrc" / f for f in ("hp_codec.cu", "hp_inverse.cu", "color_codec.cu", "ring.cu", "study.cu"))
BUILD_DIR = _PKG.parent / "build" / "tpudct_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> argument types; every function returns a cudaError_t as int.
_SIGNATURES = {
    "hp_rt_u8_launch": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _I),
    "hp_encode_u8_launch": (_P, _P, _I, _I, _I, _P, _P, _I),
    "hp_decode_u8_launch": (_P, _P, _I, _I, _P, _I, _P, _P, _I),
    "hp_rt_f32_launch": (_P, _P, _P, _I, _I, _I, _P, _P, _I),
    "hp_dct_launch": (_P, _P, _I, _I, _I, _P, _P, _I),
    "hp_idct_launch": (_P, _P, _I, _I, _P, _P, _I),
    "hp_scaled_decode_u8_launch": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I),
    "idct_split3_launch": (_P, _P, _I, _I, _P, _P, _I),
    "color_split_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I),
    "color_merge_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I),
    "color_split_direct_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I),
    "color_merge_direct_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I),
    "color_encode_u8_chain_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I),
    "color_decode_u8_chain_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I),
    "color_split_variant_launch": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _I),
    "color_merge_variant_launch": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _I),
    "ring_forward_launch": (_P, _P, _L, _P, _I),
    "ring_forward_decode_color_launch": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _P, _P, _I),
    "ring_enable_peer": (_I, _I),
    "u8_copy_launch": (_P, _P, _P, _L, _P, _I),
    "color_encode_420_launch": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _I),
    "color_decode_420_launch": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _I),
    "enc_half_launch": (_P, _P, _I, _I, _I, _P, _P, _I),
}


def nvcc_path() -> str:
    """nvcc from PATH, else from the CUDA toolkit PyTorch found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def headers() -> tuple:
    """The headers beside the sources, which they share."""
    return tuple(sorted(SOURCES[0].parent.glob("*.cuh")))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + headers():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libtpudct_torch-{h.hexdigest()[:16]}.so"


def _nvcc(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([nvcc_path(), *args], capture_output=True, text=True, check=False)


def _check(run: subprocess.CompletedProcess, what: str) -> None:
    if run.returncode:
        raise RuntimeError(f"nvcc failed ({run.returncode}) on {what}:\n{run.stderr}")


def build() -> pathlib.Path:
    """Compile the library unless this build exists; return its path.

    Each source compiles in its own nvcc process, all at once, then one
    link.  The compilers' output (``-Xptxas -v``: registers, stack, spills
    per kernel), after a line ``nvcc <source>: <seconds> s`` per source, is
    kept beside the library as ``<name>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def compile_one(src, obj):
        t0 = time.perf_counter()
        run = _nvcc(*NVCC_FLAGS, "-c", "-o", obj, str(src))
        return run, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in SOURCES]
        with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
            runs = list(pool.map(compile_one, SOURCES, objs))
        for src, (run, _) in zip(SOURCES, runs):
            _check(run, src.name)
        so = os.path.join(tmp, lib.name)
        _check(_nvcc(*NVCC_FLAGS[:2], "-shared", "-o", so, *objs), "the link")
        lib.with_suffix(".log").write_text(
            "".join(f"nvcc {src.name}: {dt:.1f} s\n" for src, (_, dt) in zip(SOURCES, runs))
            + "".join(run.stdout + run.stderr for run, _ in runs))
        os.replace(so, lib)  # atomic: a concurrent loader sees all or nothing
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


def call(fn_name: str, device, *args) -> None:
    """Launch ``fn_name(*args, stream, device)`` on ``device``'s current
    stream; raises with CUDA's message where the launch returns an error."""
    import torch

    lib = library()
    err = getattr(lib, fn_name)(*args, torch.cuda.current_stream(device).cuda_stream, device.index)
    if err:
        raise RuntimeError(f"{fn_name}: CUDA error {err}: {lib.hp_error_string(err).decode()}")
