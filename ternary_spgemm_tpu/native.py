"""ctypes bindings for the native host core (``native/ternary_native.cpp``).

The compute path runs on the device; the *host-side* one-time costs —
benchmark matrix generation and container construction — are C++ here,
mirroring the reference's native data-structure layer
(``cpp_impl/data_structures/*.h``, ``cpp_impl/sparseUtils.h:26-90``). Every
entry point has a numpy fallback, so the framework works without the .so;
``native_available()`` reports which path is active.

Build: ``make -C native`` (or :func:`build`).

Exactness contract: :func:`pack_2bit`, :func:`pack_base3`, and
:func:`tcsc_arrays` are bit-identical to the numpy implementations
(property-tested in tests/test_native.py). :func:`gen_ternary` matches the
generator's *distribution* (per-row limitPos/limitNeg with posVari,
``sparseUtils.h:54-87``) from its own seeded xoshiro256** stream.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO_PATH = os.path.join(_HERE, "native", "libternary_native.so")

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH):
        return None
    lib = ctypes.CDLL(_SO_PATH)
    i64, u64 = ctypes.c_int64, ctypes.c_uint64
    p8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.gen_ternary.argtypes = [u64, i64, i64, i64, p8]
    lib.gen_x.argtypes = [u64, i64, i64, i64, pf]
    lib.pack_2bit.argtypes = [p8, i64, i64, pu8]
    lib.pack_base3.argtypes = [p8, i64, i64, pu8]
    lib.tcsc_count.argtypes = [p8, i64, i64, p64, p64]
    lib.tcsc_fill.argtypes = [p8, i64, i64, p32, p32, p32, p32, p32, p32]
    try:
        lib.pack_bitplane.argtypes = [p8, i64, i64, i64, i64, i64, pu8]
        lib.ell_deposit_caps.argtypes = [p8, i64, i64, i64, i64, p32, p32]
        lib.ell_deposit_fill.argtypes = [p8, i64, i64, i64, i64, i64, i64,
                                         p8]
    except AttributeError:  # stale .so predating the round-2 packers
        pass
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def build(verbose: bool = False) -> bool:
    """Compile the native core in-tree (g++); returns availability."""
    try:
        out = subprocess.run(["make", "-C", os.path.join(_HERE, "native")],
                             capture_output=True, text=True, timeout=300)
        if verbose:
            print(out.stdout, out.stderr)
        global _lib
        _lib = None
        return native_available()
    except Exception:
        return False


def gen_ternary(K: int, N: int, s: int, *, seed: int = 0) -> np.ndarray:
    """Fast seeded ternary generator (Floyd sampling, O(K * N/s))."""
    lib = _load()
    if lib is None:
        from ternary_spgemm_tpu.formats.generate import generate_ternary
        return generate_ternary(K, N, s, seed=seed)
    out = np.empty((K, N), np.int8)
    lib.gen_ternary(seed, K, N, s, out)
    return out


def gen_x(M: int, K: int, *, seed: int = 0, value_range: int = 512) -> np.ndarray:
    lib = _load()
    if lib is None:
        from ternary_spgemm_tpu.formats.generate import generate_x
        return generate_x(M, K, seed=seed, value_range=value_range)
    out = np.empty((M, K), np.float32)
    lib.gen_x(seed, M, K, value_range, out)
    return out


def pack_2bit(W: np.ndarray) -> np.ndarray:
    """Stride-packed 2-bit plane; bit-exact vs PackedTernary2Bit.from_dense."""
    lib = _load()
    W = np.ascontiguousarray(W, np.int8)
    K, N = W.shape
    if lib is None:
        from ternary_spgemm_tpu.formats.packed import PackedTernary2Bit
        return PackedTernary2Bit.from_dense(W).packed
    out = np.empty(((K + 3) // 4, N), np.uint8)
    lib.pack_2bit(W, K, N, out)
    return out


def pack_base3(W: np.ndarray) -> np.ndarray:
    """Stride-packed base-3 plane; bit-exact vs PackedTernary53.from_dense."""
    lib = _load()
    W = np.ascontiguousarray(W, np.int8)
    K, N = W.shape
    if lib is None:
        from ternary_spgemm_tpu.formats.packed import PackedTernary53
        return PackedTernary53.from_dense(W).packed
    out = np.empty(((K + 4) // 5, N), np.uint8)
    lib.pack_base3(W, K, N, out)
    return out


def pack_bitplane(W: np.ndarray, tkb: int, tile_n: int):
    """The plane array of TiledBitplane's layout; bit-exact vs
    formats/bitplane.py's numpy packer (property-tested). Returns None when
    the native core is unavailable (callers fall back to numpy)."""
    lib = _load()
    if lib is None or not hasattr(lib, "pack_bitplane"):
        return None
    W = np.ascontiguousarray(W, np.int8)
    K, N = W.shape
    B = 8 * tkb
    Kp = -(-K // B) * B
    Np = -(-N // tile_n) * tile_n
    nb, gn = Kp // B, Np // tile_n
    plane = np.zeros((nb, gn, 2 * tkb, tile_n), np.uint8)
    lib.pack_bitplane(W, K, N, tkb, tile_n, gn, plane)
    return plane


def ell_deposit_arrays(W: np.ndarray, tile_n: int):
    """(plane, cap_pos, cap_neg) of TiledEllDeposit's layout;
    bit-exact vs formats/ell_deposit.py's numpy packer (property-tested).
    Returns None when the native core lacks the packers."""
    lib = _load()
    if lib is None or not hasattr(lib, "ell_deposit_caps"):
        return None
    W = np.ascontiguousarray(W, np.int8)
    K, N = W.shape
    SB, WORD_ROWS = 248, 31
    nsb = -(-K // SB)
    Np = -(-N // tile_n) * tile_n
    gn = Np // tile_n
    cap_pos = np.zeros((nsb, gn), np.int32)
    cap_neg = np.zeros((nsb, gn), np.int32)
    lib.ell_deposit_caps(W, K, N, tile_n, gn, cap_pos, cap_neg)
    cap_p = max(int(cap_pos.max()), 1)
    cap_n = max(int(cap_neg.max()), 1)
    R = 8 * (cap_p + cap_n)
    plane = np.full((nsb, gn, R, tile_n), WORD_ROWS, np.int8)
    lib.ell_deposit_fill(W, K, N, tile_n, gn, cap_p, cap_n, plane)
    return plane, cap_pos, cap_neg


def tcsc_arrays(W: np.ndarray):
    """(csp, csn, rip, rin, cip, cin) — bit-exact vs formats/tcsc.py."""
    lib = _load()
    W = np.ascontiguousarray(W, np.int8)
    K, N = W.shape
    if lib is None:
        from ternary_spgemm_tpu.formats.tcsc import TCSC
        f = TCSC.from_dense(W)
        return (f.col_start_pos, f.col_start_neg, f.row_index_pos,
                f.row_index_neg, f.col_ids_pos, f.col_ids_neg)
    np_, nm = np.zeros(1, np.int64), np.zeros(1, np.int64)
    lib.tcsc_count(W, K, N, np_, nm)
    nnz_p, nnz_n = int(np_[0]), int(nm[0])
    csp = np.empty(N + 1, np.int32)
    csn = np.empty(N + 1, np.int32)
    rip = np.empty(nnz_p, np.int32)
    rin = np.empty(nnz_n, np.int32)
    cip = np.empty(nnz_p, np.int32)
    cin = np.empty(nnz_n, np.int32)
    lib.tcsc_fill(W, K, N, csp, csn, rip, rin, cip, cin)
    return csp, csn, rip, rin, cip, cin


if __name__ == "__main__":
    ok = build(verbose=True)
    print("native core available:", ok)
