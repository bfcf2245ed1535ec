"""Brotli (de)compression via the system libbrotli, through ctypes.

The reference persists levels / assets / songs / user textures as
brotli-compressed RON with plain-text auto-detection on load
(the reference's `src/world/level.rs:242-330`, quality 11 on write).
The system libbrotlidec/libbrotlienc shared libraries are used directly,
so no Python brotli package is needed.
"""

import ctypes
import ctypes.util


def _load(names):
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError:
            continue
    found = ctypes.util.find_library(names[0].split(".")[0].replace("lib", ""))
    if found:
        return ctypes.CDLL(found)
    raise OSError(f"none of {names} could be loaded")


_dec = _load(["libbrotlidec.so.1", "libbrotlidec.so"])
_enc = _load(["libbrotlienc.so.1", "libbrotlienc.so"])

_dec.BrotliDecoderDecompress.restype = ctypes.c_int
_dec.BrotliDecoderDecompress.argtypes = [
    ctypes.c_size_t, ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]

_enc.BrotliEncoderCompress.restype = ctypes.c_int
_enc.BrotliEncoderCompress.argtypes = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_size_t, ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]

_BROTLI_DECODER_RESULT_SUCCESS = 1


def decompress(data: bytes, max_ratio: int = 4096) -> bytes:
    """One-shot decompress; grows the output buffer on overflow."""
    out_size = max(len(data) * 8, 1 << 16)
    while out_size <= len(data) * max_ratio:
        buf = ctypes.create_string_buffer(out_size)
        n = ctypes.c_size_t(out_size)
        rc = _dec.BrotliDecoderDecompress(len(data), data, ctypes.byref(n), buf)
        if rc == _BROTLI_DECODER_RESULT_SUCCESS:
            return buf.raw[:n.value]
        out_size *= 4
    raise ValueError("brotli decompress failed")


def compress(data: bytes, quality: int = 11, lgwin: int = 22) -> bytes:
    """Compress; reference writes use the brotli crate's defaults
    (quality 11, window 22 — world/level.rs:311)."""
    out_size = len(data) + (len(data) >> 1) + 1024
    buf = ctypes.create_string_buffer(out_size)
    n = ctypes.c_size_t(out_size)
    rc = _enc.BrotliEncoderCompress(quality, lgwin, 0, len(data), data,
                                    ctypes.byref(n), buf)
    if rc != 1:
        raise ValueError("brotli compress failed")
    return buf.raw[:n.value]


def maybe_decompress(data: bytes) -> bytes:
    """Auto-detect plain vs brotli like the reference's loaders: try UTF-8
    RON first (starts with '(' or comment after whitespace), else brotli."""
    head = data.lstrip()[:1]
    if head in (b"(", b"/", b"#"):
        return data
    try:
        return decompress(data)
    except ValueError:
        return data
