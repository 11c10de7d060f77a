"""Native host runtime: uid codec, CSR builder and JSON emitter in C++.

Port of `dgraph_tpu/native`, with its own copies of the sources:
`codec.cpp` (delta-varint uid lists, for checkpoints), `csr.cpp` (the
StoreBuilder's sort-dedupe-count loop) and `emit.cpp` (response bytes
from lowered level trees, `engine/emit.py`). They are compiled together
by `g++ -O3 -fPIC -std=c++17 -shared` at first use into
`dgraph_tpu_torch/build/libdgtpu-<hash>.so` (the hash is of the sources
and flags, so an edited source rebuilds) and loaded with ctypes. Each
build writes a temporary file and renames it into place, so processes
that build at once do not read a half-written library. A build failure
raises with the compiler's output; nothing is compiled at import time.

`HAVE_NATIVE` (codec and CSR builder) and `HAVE_EMIT` (emitter) are the
switches the callers read: set to False, `store._csr_from_pairs` takes
the numpy builder and `engine.emit.to_json_bytes` the dict renderer
(the tests compare the two routes that way).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from dgraph_tpu_torch.utils import locks

HAVE_NATIVE = True
HAVE_EMIT = True

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
SOURCES = ("codec.cpp", "csr.cpp", "emit.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
BUILD_TIMEOUT_S = 300

_lock = locks.make_lock("native.build")
_lib: ctypes.CDLL | None = None


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdgtpu-{h.hexdigest()[:12]}.so")


def _build(out: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found; the port's native "
                           "library is built from native/*.cpp at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp,
           *(os.path.join(_DIR, s) for s in SOURCES)]
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=BUILD_TIMEOUT_S)
    if r.returncode != 0:
        raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.dg_codec_bound.restype = ctypes.c_int64
        lib.dg_codec_bound.argtypes = [ctypes.c_int64]
        lib.dg_codec_encode.restype = ctypes.c_int64
        lib.dg_codec_encode.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.dg_codec_decode.restype = ctypes.c_int64
        lib.dg_codec_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.dg_build_csr.restype = ctypes.c_int64
        lib.dg_build_csr.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.dg_emit_block.restype = ctypes.c_int64
        lib.dg_emit_block.argtypes = [
            ctypes.POINTER(DgLevel), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.dg_emit_free.restype = None
        lib.dg_emit_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return lib


def built() -> bool:
    """Whether this process has loaded the library."""
    return _lib is not None


class DgLeaf(ctypes.Structure):
    """Mirrors emit.cpp DgLeaf (a pre-encoded column of one JSON key)."""
    _fields_ = [
        ("key", ctypes.c_void_p), ("key_len", ctypes.c_int64),
        ("kind", ctypes.c_int32), ("pad_", ctypes.c_int32),
        ("frag_off", ctypes.c_void_p), ("frag_blob", ctypes.c_void_p),
        ("nums", ctypes.c_void_p),
    ]


class DgLevel(ctypes.Structure):
    pass


class DgChild(ctypes.Structure):
    """Mirrors emit.cpp DgChild (one uid edge: key + CSR row map)."""
    _fields_ = [
        ("key", ctypes.c_void_p), ("key_len", ctypes.c_int64),
        ("level", ctypes.POINTER(DgLevel)),
        ("row_indptr", ctypes.c_void_p), ("row_child", ctypes.c_void_p),
    ]


DgLevel._fields_ = [
    ("n", ctypes.c_int64),
    ("n_leaves", ctypes.c_int64), ("leaves", ctypes.POINTER(DgLeaf)),
    ("n_children", ctypes.c_int64), ("children", ctypes.POINTER(DgChild)),
    ("level_id", ctypes.c_int64),
]


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def emit_block(root: DgLevel, display: np.ndarray, n_levels: int) -> bytes:
    """One block's JSON array from a lowered level tree. `display`: int32
    domain positions to render at the root. The caller keeps every
    referenced numpy array and bytes object alive for the call."""
    lib = load()
    display = np.ascontiguousarray(display, np.int32)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.dg_emit_block(ctypes.byref(root), _ptr(display, ctypes.c_int32),
                          len(display), n_levels, ctypes.byref(out))
    if n < 0:
        raise MemoryError("dg_emit_block allocation failed")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.dg_emit_free(out)


def codec_encode(uids: np.ndarray) -> bytes:
    """Sorted nonnegative int64 uids → delta-varint (LEB128) bytes."""
    uids = np.ascontiguousarray(uids, np.int64)
    lib = load()
    out = np.empty(int(lib.dg_codec_bound(len(uids))), np.uint8)
    n = lib.dg_codec_encode(_ptr(uids, ctypes.c_int64), len(uids),
                            _ptr(out, ctypes.c_uint8))
    if n < 0:
        raise ValueError("uids not sorted ascending")
    return out[:n].tobytes()


def codec_decode(buf: bytes, n: int) -> np.ndarray:
    """Delta-varint bytes → sorted int64 uids[n]; raises when the buffer
    holds fewer."""
    lib = load()
    raw = np.frombuffer(buf, np.uint8)
    out = np.empty(n, np.int64)
    got = lib.dg_codec_decode(_ptr(raw, ctypes.c_uint8), len(raw), n,
                              _ptr(out, ctypes.c_int64))
    if got != n:
        raise ValueError(f"decoded {got} of {n} uids")
    return out


def build_csr(src: np.ndarray, dst: np.ndarray, n: int):
    """Edge pairs → (indptr[int32, n+1], indices[int32, nnz]): rows
    sorted, pairs deduped; equal to the numpy builder's output."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    if len(src) != len(dst):
        raise ValueError("src and dst differ in length")
    m = len(src)
    indptr = np.empty(n + 1, np.int32)
    indices = np.empty(m, np.int32)
    scratch = np.empty(m, np.uint64)
    nnz = load().dg_build_csr(
        _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32), m, n,
        _ptr(indptr, ctypes.c_int32), _ptr(indices, ctypes.c_int32),
        _ptr(scratch, ctypes.c_uint64))
    if nnz < 0:
        raise ValueError("rank out of range in edge pairs")
    return indptr, indices[:nnz].copy()
