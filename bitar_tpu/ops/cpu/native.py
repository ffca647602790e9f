"""ctypes loader (and on-demand builder) for the native host codec library.

The reference binds to native code through DPDK's C ABI; here the framework
owns the native layer and binds via ctypes (pybind11 is not available in the
environment).  The library is built with g++ into ``ops/cpu/build`` under a
name keyed by a hash of its sources, so a library copied in with a tree
whose sources differ is never loaded: a changed source means a new name
and a fresh build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ...status import Status, StatusError

_SRC_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _SRC_DIR / "build"
_SOURCES = ["lz4.cc", "snappy.cc", "zstd.cc", "batch.cc"]
_HEADERS = ["bitar_host.h"]
_ABI_VERSION = 7

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    return _BUILD_DIR / f"libbitar_host-{_source_hash()}.so"


def _build(dest: Path) -> None:
    """Compile the sources into ``dest`` (atomically: concurrent builders
    each write their own temporary file and the last rename wins)."""
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = dest.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
           "-Wall", "-o", str(tmp)]
    cmd += [str(_SRC_DIR / s) for s in _SOURCES]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise StatusError(Status.IOError(
            f"native build failed: {r.stderr[-2000:]}"))
    os.replace(tmp, dest)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    for name in ("bt_lz4_compress", "bt_lz4_decompress",
                 "bt_snappy_compress", "bt_snappy_decompress",
                 "bt_zstd_compress", "bt_zstd_decompress"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [u8p, ctypes.c_int, u8p, ctypes.c_int]
    for name in ("bt_lz4_compress_mm", "bt_snappy_compress_mm"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [u8p, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int]
    lib.bt_snappy_uncompressed_len.restype = ctypes.c_int
    lib.bt_snappy_uncompressed_len.argtypes = [u8p, ctypes.c_int]
    for name in ("bt_lz4_parse", "bt_snappy_parse"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [u8p, ctypes.c_int, ctypes.c_int, i32p, i32p, i32p, i32p, i32p]
    lib.bt_batch_compress.restype = None
    lib.bt_batch_compress.argtypes = [
        ctypes.c_int, i32p, ctypes.c_int, ctypes.c_int,
        u8p, i64p, i32p, u8p, i64p, i32p, i32p, ctypes.c_int]
    lib.bt_batch_decompress.restype = None
    lib.bt_batch_decompress.argtypes = [
        ctypes.c_int, i32p, ctypes.c_int, ctypes.c_int,
        u8p, i64p, i32p, u8p, i64p, i32p, i32p]
    lib.bt_zstd_parse.restype = ctypes.c_int
    lib.bt_zstd_parse.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                  u8p, ctypes.c_int, i32p,
                                  i32p, i32p, i32p, i32p, i32p]
    lib.bt_abi_version.restype = ctypes.c_int
    lib.bt_abi_version.argtypes = []
    return lib


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library; thread-safe, idempotent."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = _bind(ctypes.CDLL(str(path)))
        got = lib.bt_abi_version()
        if got != _ABI_VERSION:
            raise StatusError(Status.IOError(
                f"native ABI version {got} != expected {_ABI_VERSION}"))
        _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# numpy-friendly wrappers


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _as_u8(data) -> np.ndarray:
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) \
        else np.ascontiguousarray(data, dtype=np.uint8)
    return arr


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise StatusError(Status.from_int(rc, what))
    return rc


def lz4_compress(data, dst_cap: int | None = None,
                 min_match: int = 4) -> np.ndarray:
    src = _as_u8(data)
    cap = dst_cap if dst_cap is not None else len(src) + len(src) // 255 + 16
    dst = np.empty(cap, dtype=np.uint8)
    rc = _check(load().bt_lz4_compress_mm(_u8ptr(src), len(src), _u8ptr(dst),
                                          cap, min_match),
                "lz4_compress")
    return dst[:rc]


def lz4_decompress(data, dst_cap: int) -> np.ndarray:
    src = _as_u8(data)
    dst = np.empty(dst_cap, dtype=np.uint8)
    rc = _check(load().bt_lz4_decompress(_u8ptr(src), len(src), _u8ptr(dst), dst_cap),
                "lz4_decompress")
    return dst[:rc]


def snappy_compress(data, dst_cap: int | None = None,
                    min_match: int = 4) -> np.ndarray:
    src = _as_u8(data)
    cap = dst_cap if dst_cap is not None else 32 + len(src) + len(src) // 6
    dst = np.empty(cap, dtype=np.uint8)
    rc = _check(load().bt_snappy_compress_mm(_u8ptr(src), len(src),
                                             _u8ptr(dst), cap, min_match),
                "snappy_compress")
    return dst[:rc]


def snappy_decompress(data, dst_cap: int | None = None) -> np.ndarray:
    src = _as_u8(data)
    if dst_cap is None:
        dst_cap = _check(load().bt_snappy_uncompressed_len(_u8ptr(src), len(src)),
                         "snappy_uncompressed_len")
    dst = np.empty(max(1, dst_cap), dtype=np.uint8)
    rc = _check(load().bt_snappy_decompress(_u8ptr(src), len(src), _u8ptr(dst), dst_cap),
                "snappy_decompress")
    return dst[:rc]


def zstd_compress(data, dst_cap: int | None = None) -> np.ndarray:
    """Native from-scratch zstd frame encode (ops/cpu/zstd.cc).

    Greedy LZ matching with raw literals and predefined-FSE sequence
    coding; incompressible blocks fall back to raw, so worst-case output
    is src_len + 3 bytes per 128 KiB block + frame header.
    """
    src = _as_u8(data)
    cap = dst_cap if dst_cap is not None else len(src) + len(src) // 255 + 64
    dst = np.empty(max(1, cap), dtype=np.uint8)
    rc = _check(load().bt_zstd_compress(_u8ptr(src), len(src), _u8ptr(dst),
                                        cap), "zstd_compress")
    return dst[:rc]


def zstd_decompress(data, dst_cap: int) -> np.ndarray:
    """Native from-scratch zstd frame decode (ops/cpu/zstd.cc)."""
    src = _as_u8(data)
    dst = np.empty(max(1, dst_cap), dtype=np.uint8)
    rc = _check(load().bt_zstd_decompress(_u8ptr(src), len(src), _u8ptr(dst),
                                          dst_cap), "zstd_decompress")
    return dst[:rc]


def zstd_parse(data, max_seq: int | None = None, lit_cap: int | None = None):
    """Parse a zstd frame into the SoA sequence table + decoded literals.

    Returns (tables dict, literals uint8 array); lit_ptr indexes into the
    LITERALS array (entropy-decoded on host), unlike lz4/snappy where it
    indexes the compressed stream.
    """
    src = _as_u8(data)
    if max_seq is None:
        max_seq = max(16, len(src) * 2 + 16)
    if lit_cap is None:
        lit_cap = max(64, len(src) * 16 + 1024)
    cols = {k: np.zeros(max_seq, dtype=np.int32)
            for k in ("lit_ptr", "lit_len", "off", "mlen", "out_pos")}
    lit_buf = np.empty(lit_cap, dtype=np.uint8)
    lit_used = np.zeros(1, dtype=np.int32)
    rc = _check(load().bt_zstd_parse(
        _u8ptr(src), len(src), max_seq, _u8ptr(lit_buf), lit_cap,
        _i32ptr(lit_used),
        _i32ptr(cols["lit_ptr"]), _i32ptr(cols["lit_len"]),
        _i32ptr(cols["off"]), _i32ptr(cols["mlen"]),
        _i32ptr(cols["out_pos"])), "zstd_parse")
    return ({k: v[:rc].copy() for k, v in cols.items()},
            lit_buf[:int(lit_used[0])].copy())


def parse_sequences(data, codec: str = "lz4", max_seq: int | None = None):
    """Extract the SoA sequence table feeding the device decode executor.

    Returns dict of int32 arrays (lit_ptr, lit_len, off, mlen, out_pos) of
    length nseq.
    """
    src = _as_u8(data)
    if max_seq is None:
        max_seq = max(16, len(src) + 1)
    cols = {k: np.zeros(max_seq, dtype=np.int32)
            for k in ("lit_ptr", "lit_len", "off", "mlen", "out_pos")}
    fn = load().bt_lz4_parse if codec == "lz4" else load().bt_snappy_parse
    rc = _check(fn(_u8ptr(src), len(src), max_seq,
                   _i32ptr(cols["lit_ptr"]), _i32ptr(cols["lit_len"]),
                   _i32ptr(cols["off"]), _i32ptr(cols["mlen"]),
                   _i32ptr(cols["out_pos"])), f"{codec}_parse")
    return {k: v[:rc].copy() for k, v in cols.items()}


_CODEC_INT = {"lz4": 0, "snappy": 1, "zstd": 2, "raw": 3}


def batch_run(compress: bool, codec: str, src: np.ndarray, src_off: np.ndarray,
              src_len: np.ndarray, dst: np.ndarray, dst_off: np.ndarray,
              dst_cap: np.ndarray, nthreads: int = 0,
              codec_ids: np.ndarray | None = None, min_match: int = 4):
    """Multithreaded batch (de)compress over packed byte arrays.

    Returns (dst_len int32 array, status int32 array); raises nothing — the
    caller inspects per-block status (matching the reference's per-op status
    walk at dequeue, src/device.cc:512-520).

    ``min_match``: smallest match length the LZ4/Snappy encoders emit
    (compress only; see ``bt_lz4_compress_mm``).
    """
    n = int(src_len.shape[0])
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    dst_len = np.ascontiguousarray(dst_cap, dtype=np.int32).copy()
    status = np.zeros(n, dtype=np.int32)
    src_off = np.ascontiguousarray(src_off, dtype=np.int64)
    dst_off = np.ascontiguousarray(dst_off, dtype=np.int64)
    src_len = np.ascontiguousarray(src_len, dtype=np.int32)
    ids_ptr = _i32ptr(np.ascontiguousarray(codec_ids, dtype=np.int32)) \
        if codec_ids is not None else None
    args = (_CODEC_INT[codec], ids_ptr, nthreads, n,
            _u8ptr(src), _i64ptr(src_off), _i32ptr(src_len),
            _u8ptr(dst), _i64ptr(dst_off), _i32ptr(dst_len), _i32ptr(status))
    if compress:
        load().bt_batch_compress(*args, min_match)
    else:
        load().bt_batch_decompress(*args)
    return dst_len, status
