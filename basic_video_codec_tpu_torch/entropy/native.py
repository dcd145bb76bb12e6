"""ctypes bindings for the host entropy codec (``native/entropy.cc``).

The library is built with g++ at first use into the package's ``_build/``
directory (utils/build.py).  If it cannot be built or loaded, the call
raises: the codec has no second implementation to fall back to.
"""

import ctypes

import numpy as np

from ..utils.build import build_shared

VERSION = 1

_lib = None


def build() -> str:
    """Compile the library if it is missing or stale; return its path."""
    return build_shared("native/entropy.cc", "libbvc_entropy_torch.so",
                        ["g++", "-O3", "-fPIC", "-shared", "-std=c++17"])


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    for name, args in (
        ("bvc_encode_symbols", [ptr, i64, ptr, i64]),
        ("bvc_decode_symbols", [ptr, i64, ptr, i64]),
        ("bvc_decode_dct_blocks", [ptr, i64, ptr, i64, i64, i64]),
        ("bvc_encode_dct_plane", [ptr, i64, i64, i64, ptr, i64, ptr, i64]),
        ("bvc_format_mv_lines", [ptr, i64, i64, i64, ptr, i64]),
        ("bvc_sse", [ptr, ptr, i64]),
        ("bvc_version", []),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = i64, args
    lib.bvc_wrap_diff.restype = None
    lib.bvc_wrap_diff.argtypes = [ptr, ptr, ptr, i64]
    if lib.bvc_version() != VERSION:
        raise RuntimeError(
            f"entropy library version {lib.bvc_version()} != {VERSION}")
    _lib = lib
    return lib


def encode_symbols_bytes(symbols: np.ndarray):
    """Signed symbols -> (packed bytes, bit length)."""
    symbols = np.ascontiguousarray(symbols, dtype=np.int64)
    cap = symbols.size * 8 + 64  # worst-case codeword here is ~63 bits
    out = np.zeros(cap, dtype=np.uint8)
    nbits = _load().bvc_encode_symbols(
        symbols.ctypes.data, symbols.size, out.ctypes.data, cap)
    if nbits < 0:
        raise RuntimeError("symbol stream exceeded its buffer")
    return out[: (nbits + 7) // 8].tobytes(), int(nbits)


def decode_symbols_np(data: bytes, max_symbols: int) -> np.ndarray:
    """Packed bytes -> up to ``max_symbols`` decoded symbols (int64)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros(max_symbols, dtype=np.int64)
    n = _load().bvc_decode_symbols(
        buf.ctypes.data, buf.size * 8, out.ctypes.data, max_symbols)
    return out[:n]


def encode_dct_plane_bytes(qdct: np.ndarray, bs: int, zz: np.ndarray, eob: int):
    """int16 qdct plane -> (packed bytes, bit length): zigzag + RLE +
    exp-Golomb + per-block EOB in one native pass."""
    q = np.ascontiguousarray(qdct, dtype=np.int16)
    h, w = q.shape
    zz64 = np.ascontiguousarray(zz, dtype=np.int64)
    cap = h * w * 4 + 1024  # worst case ~27 bits per coefficient
    out = np.zeros(cap, dtype=np.uint8)
    nbits = _load().bvc_encode_dct_plane(
        q.ctypes.data, h, w, bs, zz64.ctypes.data, eob, out.ctypes.data, cap)
    if nbits < 0:
        raise RuntimeError("DCT stream exceeded its buffer")
    return out[: (nbits + 7) // 8].tobytes(), int(nbits)


def decode_dct_scans(data: bytes, n_blocks: int, scan_len: int, eob: int) -> np.ndarray:
    """DCT payload -> ``[n_blocks, scan_len]`` int32 zigzag scans."""
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros((n_blocks, scan_len), dtype=np.int32)
    _load().bvc_decode_dct_blocks(
        buf.ctypes.data, buf.size * 8, out.ctypes.data, n_blocks, scan_len, eob)
    return out


def format_mv_lines(mvs: np.ndarray, bs: int) -> str:
    """mv.txt line for one frame (x-major order)."""
    nbr, nbc = mvs.shape[:2]
    m = np.ascontiguousarray(mvs, dtype=np.int32)
    cap = nbr * nbc * 64 + 16
    out = np.zeros(cap, dtype=np.uint8)
    n = _load().bvc_format_mv_lines(m.ctypes.data, nbr, nbc, bs,
                                    out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("mv line exceeded its buffer")
    return out[:n].tobytes().decode("ascii")


def wrap_diff(curr: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """``(curr - prev) mod 256`` of two u8 planes."""
    c = np.ascontiguousarray(curr, np.uint8)
    p = np.ascontiguousarray(prev, np.uint8)
    if c.shape != p.shape:
        raise ValueError(f"plane shapes differ: {c.shape} vs {p.shape}")
    out = np.empty_like(c)
    _load().bvc_wrap_diff(c.ctypes.data, p.ctypes.data, out.ctypes.data, c.size)
    return out


def sse(a: np.ndarray, b: np.ndarray) -> int:
    """Sum of squared differences of two u8 planes."""
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    if a.shape != b.shape:
        raise ValueError(f"plane shapes differ: {a.shape} vs {b.shape}")
    return int(_load().bvc_sse(a.ctypes.data, b.ctypes.data, a.size))
