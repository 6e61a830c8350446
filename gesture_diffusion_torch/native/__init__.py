"""The host-side float parser of the BVH MOTION block, loaded with ctypes.

``csrc/fast_parse.cpp`` (one ``strtod`` pass, a copy of the JAX package's
``native/fast_parse.cpp``) is compiled with ``g++`` at first use into
``build/host/`` (``ops/kernel_build.py::build_host_library``).  It is a
speed-up of the data loader on the host, not a device kernel: a 70 s BEAT
recording holds about 1.9 M float tokens in 17 MB of text.

Unlike the JAX package's loader, this one does not fall back to numpy: a
missing or failing compiler raises.  ``parse_floats_plain`` is the numpy
route, the plain version that the tests hold the parser against; nothing
on the main path calls it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops.kernel_build import build_host_library


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_host_library("fast_parse")))
    lib.gdt_parse_floats.restype = ctypes.c_long
    lib.gdt_parse_floats.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long]
    return lib


def _prepare(text: "str | bytes", expected: "int | None"):
    data = text.encode() if isinstance(text, str) else bytes(text)
    return data, len(data.split()) if expected is None else int(expected)


def parse_floats(text: "str | bytes", expected: "int | None" = None
                 ) -> np.ndarray:
    """Up to ``expected`` whitespace-separated floats of ``text`` (str or
    ASCII bytes) as float64, stopping at the first non-numeric token (the
    BVH motion-block grammar).  ``expected`` defaults to the number of
    whitespace-separated tokens."""
    data, expected = _prepare(text, expected)
    if expected <= 0:
        return np.zeros(0)
    out = np.empty(expected, np.float64)
    # ctypes passes bytes with their terminating NUL, which strtod needs
    n = _library().gdt_parse_floats(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        expected)
    return out[:n]


def parse_floats_plain(text: "str | bytes", expected: "int | None" = None
                       ) -> np.ndarray:
    """``parse_floats`` through numpy: the token list is cut to
    ``expected`` before converting."""
    data, expected = _prepare(text, expected)
    if expected <= 0:
        return np.zeros(0)
    toks = data.split()[:expected]
    try:
        return np.asarray(toks, dtype=np.float64)
    except ValueError:
        out = np.empty(len(toks), np.float64)
        n = 0
        for tok in toks:
            try:
                out[n] = float(tok)
            except ValueError:
                break
            n += 1
        return out[:n]


__all__ = ["parse_floats", "parse_floats_plain"]
