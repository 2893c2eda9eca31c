"""Native (C) codecs of the port's slide readers (a copy of
``mhim_mil_tpu/native``): TIFF LZW (compression 5) and PackBits (32773),
the two codecs the Python reader would otherwise run byte by byte. JPEG and
deflate already decode in C through PIL and zlib.

``lzw.c`` is compiled on first use by the host's C compiler (``cc``, else
``gcc``) into ``build/native/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source, and loaded with ctypes.
Without a compiler the pure-Python decoders give the same bytes;
:func:`have_native` says which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "lzw.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the built codec lives: ``build/native/_tiffcodec-<hash>.so``."""
    return BUILD_DIR / f"_tiffcodec-{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]}.so"


def _load():
    """Build (once, quietly) and dlopen the codec library. Returns None when
    unavailable so callers fall back to the Python implementations."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not so.exists():
                compiler = shutil.which("cc") or shutil.which("gcc")
                if compiler is None:
                    return None
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                subprocess.run([compiler, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                               check=True, capture_output=True, timeout=60)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            for fn in ("tiff_lzw_decode", "tiff_packbits_decode"):
                f = getattr(lib, fn)
                f.restype = ctypes.c_long
                f.argtypes = [
                    ctypes.c_char_p, ctypes.c_long,
                    ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long,
                ]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def have_native() -> bool:
    return _load() is not None


def lzw_decode(data: bytes, cap: int) -> bytes:
    """TIFF LZW decode, at most ``cap`` output bytes (tile geometry bound).
    Native when available, else the pure-Python decoder."""
    lib = _load()
    if lib is None:
        from ..preprocess.tiff import _lzw_decode_py

        return _lzw_decode_py(data)[:cap]
    out = (ctypes.c_ubyte * cap)()
    n = lib.tiff_lzw_decode(data, len(data), out, cap)
    if n < 0:
        raise ValueError("malformed LZW stream")
    return bytes(bytearray(out)[:n])


def packbits_decode(data: bytes, cap: int) -> bytes:
    """TIFF PackBits decode, at most ``cap`` output bytes."""
    lib = _load()
    if lib is None:
        return _packbits_decode_py(data, cap)
    out = (ctypes.c_ubyte * cap)()
    n = lib.tiff_packbits_decode(data, len(data), out, cap)
    if n < 0:
        raise ValueError("malformed PackBits stream")
    return bytes(bytearray(out)[:n])


def _packbits_decode_py(data: bytes, cap: int) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < cap:
        n = data[i]
        i += 1
        if n < 128:
            out += data[i : i + n + 1]
            i += n + 1
        elif n > 128:
            if i < len(data):
                out += bytes([data[i]]) * (257 - n)
                i += 1
    return bytes(out[:cap])
