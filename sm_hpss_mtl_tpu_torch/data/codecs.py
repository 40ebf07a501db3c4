"""Compressed-audio input (mp3) through the system ``libmpg123``.

A copy of ``sm_hpss_mtl_tpu/data/codecs.py`` (the JAX package's module
imports JAX through its package), pinned to it by
``tests/test_torch_codecs.py``: the code below the docstring is the same.
The reference loads anything librosa decodes and ships its HPSS demo
assets as mp3; ``libmpg123.so.0`` decodes MPEG layers I-III, bound with
ctypes, with no compile step and no bundled decoder.  Where the library is
missing, :func:`available` is False and decoding raises ``OSError``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os

import numpy as np

MPG123_OK = 0
MPG123_DONE = -12
MPG123_ENC_SIGNED_16 = 0xD0

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = ctypes.util.find_library("mpg123") or "libmpg123.so.0"
    lib = ctypes.CDLL(path)
    c = ctypes
    lib.mpg123_init.restype = c.c_int
    lib.mpg123_new.argtypes = [c.c_char_p, c.POINTER(c.c_int)]
    lib.mpg123_new.restype = c.c_void_p
    lib.mpg123_open.argtypes = [c.c_void_p, c.c_char_p]
    lib.mpg123_open.restype = c.c_int
    lib.mpg123_getformat.argtypes = [c.c_void_p, c.POINTER(c.c_long),
                                     c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.mpg123_getformat.restype = c.c_int
    lib.mpg123_format_none.argtypes = [c.c_void_p]
    lib.mpg123_format.argtypes = [c.c_void_p, c.c_long, c.c_int, c.c_int]
    lib.mpg123_format.restype = c.c_int
    lib.mpg123_read.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t,
                                c.POINTER(c.c_size_t)]
    lib.mpg123_read.restype = c.c_int
    lib.mpg123_scan.argtypes = [c.c_void_p]
    lib.mpg123_scan.restype = c.c_int
    lib.mpg123_length.argtypes = [c.c_void_p]
    lib.mpg123_length.restype = c.c_long
    lib.mpg123_close.argtypes = [c.c_void_p]
    lib.mpg123_delete.argtypes = [c.c_void_p]
    lib.mpg123_strerror.argtypes = [c.c_void_p]
    lib.mpg123_strerror.restype = c.c_char_p
    lib.mpg123_init()
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def _err(lib, handle, what: str) -> RuntimeError:
    msg = lib.mpg123_strerror(handle)
    return RuntimeError(f"mpg123 {what}: {msg.decode() if msg else '?'}")


def _open(path: str):
    lib = _load()
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed (err={err.value})")
    if lib.mpg123_open(h, os.fsencode(path)) != MPG123_OK:
        e = _err(lib, h, f"open({path})")
        lib.mpg123_delete(h)
        raise e
    rate = ctypes.c_long(0)
    channels = ctypes.c_int(0)
    enc = ctypes.c_int(0)
    if lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                            ctypes.byref(enc)) != MPG123_OK:
        e = _err(lib, h, "getformat")
        lib.mpg123_close(h)
        lib.mpg123_delete(h)
        raise e
    return lib, h, rate.value, channels.value


def _close(lib, h) -> None:
    lib.mpg123_close(h)
    lib.mpg123_delete(h)


def read_mp3(path: str) -> tuple[np.ndarray, int]:
    """Decode an mp3 to float32 samples.

    Returns ``(x, sample_rate)`` with ``x`` of shape ``(n,)`` mono or
    ``(n, channels)``.  The stream is pinned to its native rate/channels
    at signed-16 output (the one encoding every libmpg123 build supports
    — this image's copy is an integer-only decoder that silently ignores
    float requests) and converted to float32 in [-1, 1).
    """
    lib, h, rate, channels = _open(path)
    try:
        lib.mpg123_format_none(h)
        if lib.mpg123_format(h, rate, channels,
                             MPG123_ENC_SIGNED_16) != MPG123_OK:
            raise _err(lib, h, "format")
        chunks = []
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(buf.raw[:done.value])
            if rc == MPG123_DONE:
                break
            if rc not in (MPG123_OK,):
                raise _err(lib, h, f"read (rc={rc})")
    finally:
        _close(lib, h)
    raw = np.frombuffer(b"".join(chunks), dtype=np.int16)
    x = raw.astype(np.float32) / 32768.0
    if channels > 1:
        x = x.reshape(-1, channels)
    return x, rate


def mp3_duration_seconds(path: str) -> float:
    """Stream length in seconds without a full decode (header scan)."""
    lib, h, rate, _ = _open(path)
    try:
        lib.mpg123_scan(h)
        n = lib.mpg123_length(h)
        if n <= 0:
            raise RuntimeError(f"mpg123_length failed on {path}")
        return n / rate
    finally:
        _close(lib, h)
