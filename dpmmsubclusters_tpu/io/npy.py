"""Data loading (reference ``src/utils.jl:5-14``).

The reference stores datasets as ``.npy`` files laid out N x D and loads
them with a NaN -> 0 scrub and a transpose to its internal D x N layout.
The framework's internal layout is [N, D] (rows = points), so
``load_data`` only scrubs -- no transpose (pass ``swapdims=True`` for
reference-layout D x N files).

For multi-GB files the scrub/cast/transpose runs through the native OpenMP
library (``native/fastload.cc``: mmap + parallel blocked conversion, built
by ``native/build.sh``); pure-numpy is the automatic fallback when the
shared library is absent.
"""
from __future__ import annotations

import ast
import ctypes
import mmap
import os
import threading

import numpy as np

_DTYPE_CODES = {
    "<f4": 0, "<f8": 1, "<i4": 2, "<i8": 3,
    "|u1": 4, "<i2": 5, "<u2": 6, "|i1": 7,
}

_lib = None
_lib_lock = threading.Lock()
_NATIVE_MIN_BYTES = 1 << 22  # files under 4 MiB: numpy is fast enough


def _native_lib():
    """Load (building if possible) the native fastload library; None if
    unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib if _lib is not False else None
        root = os.path.join(os.path.dirname(__file__), "..", "..", "native")
        so = os.path.abspath(os.path.join(root, "libdpmmfastload.so"))
        if not os.path.exists(so):
            import subprocess

            try:
                subprocess.run(
                    ["sh", os.path.join(root, "build.sh")],
                    capture_output=True, timeout=120, check=True,
                )
            except Exception:
                _lib = False
                return None
        try:
            lib = ctypes.CDLL(so)
            lib.dpmm_convert.restype = ctypes.c_int
            lib.dpmm_convert.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ]
            _lib = lib
            return lib
        except Exception:
            _lib = False
            return None


def _parse_npy_header(f):
    """Returns (dtype_str, fortran, shape, data_offset)."""
    magic = f.read(6)
    if magic != b"\x93NUMPY":
        raise ValueError("not an npy file")
    major, _minor = f.read(1)[0], f.read(1)[0]
    if major == 1:
        hlen = int.from_bytes(f.read(2), "little")
    else:
        hlen = int.from_bytes(f.read(4), "little")
    header = f.read(hlen).decode("latin1")
    d = ast.literal_eval(header)
    return d["descr"], d["fortran_order"], d["shape"], f.tell()


def load_data(path: str, *, prefix: str = "", swapdims: bool = False
              ) -> np.ndarray:
    """Load ``{path}{prefix}.npy`` (or a full filename) as float32 [N, D]
    with NaN -> 0 scrub (exactly like the reference loader)."""
    fname = path if path.endswith(".npy") else f"{path}{prefix}.npy"

    lib = _native_lib()
    if lib is not None and os.path.getsize(fname) >= _NATIVE_MIN_BYTES:
        with open(fname, "rb") as f:
            descr, fortran, shape, off = _parse_npy_header(f)
            code = _DTYPE_CODES.get(descr)
            if code is not None and not fortran and len(shape) == 2:
                r, c = shape
                n, d = (c, r) if swapdims else (r, c)
                out = np.empty((n, d), np.float32)
                with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
                    view = np.frombuffer(mm, dtype=np.uint8)
                    try:
                        rc = lib.dpmm_convert(
                            ctypes.c_void_p(
                                view.ctypes.data + off
                            ),
                            code,
                            out.ctypes.data_as(ctypes.c_void_p),
                            n, d, 1 if swapdims else 0,
                        )
                    finally:
                        del view  # release the exported mmap buffer
                if rc == 0:
                    return out
            # header we can't handle natively: fall through to numpy

    arr = np.load(fname)
    arr = np.nan_to_num(np.asarray(arr, np.float32), nan=0.0)
    if swapdims:
        arr = arr.T
    return np.ascontiguousarray(arr)
