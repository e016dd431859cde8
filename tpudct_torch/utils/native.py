"""Build and load the host C libraries of the port: the entropy coder and
the JPEG codec.

Two shared libraries, compiled with the system C compiler from the sources
in ``csrc/`` at the root of the checkout (read there, never written there):

- the entropy library, ``csrc/entropy.c`` alone (libc, ``math.h`` and
  pthreads only): the Huffman and rANS coders of the ``.tdc`` stages;
- the JPEG library, ``csrc/jpeg_codec.c`` linked against libjpeg: the
  ``.jpg`` reader and writers of :mod:`tpudct_torch.utils.imageio` and the
  coefficient reader and writer of :mod:`tpudct_torch.utils.jpegcoef`.

The flags are ``csrc/Makefile``'s (``-O3 -march=native -Wall -fPIC -pthread
-shared``, libraries ``-lpthread -lm``, plus ``-ljpeg`` for the JPEG
library): the rANS v3 stage picks its stream version by Shannon costs
(``log2``), so the same compiler and flags on one host give the same bytes
as the reference package's library.  Each library goes into
``build/tpudct_torch/`` named by a hash of its source, the compiler and the
flags, written to a temporary file and moved into place, so concurrent
processes may build at once.

A failed entropy build raises with the compiler's stderr.  A failed JPEG
build (no libjpeg headers) leaves the JPEG entry points unavailable: the
pixel callers fall back to PIL, as the reference does, and the coefficient
I/O, which has no fallback, raises.  Setting
``TPUDCT_NO_NATIVE_JPEG`` turns both libraries off, as it turns off the
reference's one library: the entropy decoders then run their pure-Python
forms and the encoders that need the library raise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "tpudct_torch"
CFLAGS = ("-O3", "-march=native", "-Wall", "-fPIC", "-pthread", "-shared")
# library -> (source, link libraries)
LIBRARIES = {
    "entropy": ("entropy.c", ("-lpthread", "-lm")),
    "jpeg": ("jpeg_codec.c", ("-ljpeg", "-lpthread", "-lm")),
}

_I, _L, _P = ctypes.c_int, ctypes.c_long, ctypes.c_void_p
_U8P = ctypes.POINTER(ctypes.c_ubyte)
_IP = ctypes.POINTER(ctypes.c_int)
_I16PP = ctypes.POINTER(ctypes.POINTER(ctypes.c_short))
_U16P = ctypes.POINTER(ctypes.c_ushort)
# library -> name -> (result type, argument types)
_SIGNATURES = {
    "entropy": {
        "tpudct_huff_encode": (_L, (_P, _I, _I, _P, _L)),
        "tpudct_huff_decode": (_I, (_P, _L, _I, _I, _P)),
        # ..., force_bands, interleave (0/1 serial, 4 = the v4 stream)
        "tpudct_rans_encode": (_L, (_P, _I, _I, _P, _L, _I, _I)),
        "tpudct_rans_decode": (_I, (_P, _L, _I, _I, _P)),
    },
    "jpeg": {
        "tpudct_jpeg_decode": (_I, (ctypes.c_char_p, ctypes.POINTER(_U8P), _IP, _IP, _IP, _I)),
        "tpudct_jpeg_encode_ch": (_I, (ctypes.c_char_p, _U8P, _I, _I, _I, _I)),
        "tpudct_jpeg_encode_mem": (
            _I, (_U8P, _I, _I, _I, _I, ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_ulong))),
        "tpudct_jpeg_decode_batch": (
            _I, (ctypes.POINTER(ctypes.c_char_p), _I, _I, ctypes.POINTER(_U8P), _IP, _IP, _IP, _IP, _I)),
        # the coefficient-level entry points (utils/jpegcoef.py): path, maps,
        # map widths and heights, tables, sampling factors, then the counts
        "tpudct_jpeg_read_coefs": (
            _I, (ctypes.c_char_p, _I16PP, _IP, _IP, _U16P, _IP, _IP, _IP, _IP, _IP)),
        "tpudct_jpeg_write_coefs_ex": (
            _I, (ctypes.c_char_p, _I16PP, _IP, _IP, _U16P, _IP, _IP, _I, _I, _I, _I)),
        "tpudct_free": (None, (_U8P,)),
    },
}


def compiler() -> str:
    return os.environ.get("CC") or "cc"


def command(name: str, out: str) -> list:
    """The compiler's command line for library ``name`` written to ``out``."""
    src, libs = LIBRARIES[name]
    return [compiler(), *CFLAGS, "-o", out, str(CSRC / src), *libs]


def library_path(name: str) -> pathlib.Path:
    src, libs = LIBRARIES[name]
    h = hashlib.sha256(" ".join((compiler(), *CFLAGS, *libs)).encode())
    h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"libtpudct_{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile library ``name`` unless this build exists; return its path.
    Raises with the compiler's stderr where it fails."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{lib.stem}-", suffix=".so")
    os.close(fd)
    try:
        run = subprocess.run(command(name, tmp), capture_output=True, text=True, check=False)
        if run.returncode:
            raise RuntimeError(
                f"{compiler()} failed ({run.returncode}) on csrc/{LIBRARIES[name][0]}:\n{run.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def disabled() -> bool:
    """``TPUDCT_NO_NATIVE_JPEG`` is set: both libraries are off."""
    return bool(os.environ.get("TPUDCT_NO_NATIVE_JPEG"))


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(name)))
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = list(argtypes)
    return lib


def entropy_library() -> Optional[ctypes.CDLL]:
    """The entropy library, built at first use; None where it is turned
    off.  A failed build raises."""
    return None if disabled() else _load("entropy")


@functools.cache
def _jpeg_or_none() -> Optional[ctypes.CDLL]:
    try:
        return _load("jpeg")
    except (RuntimeError, OSError):
        return None


def jpeg_library() -> Optional[ctypes.CDLL]:
    """The JPEG library, built at first use; None where it is turned off or
    does not build (no libjpeg)."""
    return None if disabled() else _jpeg_or_none()
