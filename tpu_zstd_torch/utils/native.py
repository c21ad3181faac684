"""ctypes loader for the native host runtime (csrc/host/*.cpp).

The port's copies of the reference's C++ sources (`tpu_zstd_native.cpp`:
XXH64/32, the frame assembler, the Huffman stream decoder;
`tpu_zstd_engine.cpp`: a greedy RFC 8878 codec behind a C API) build at
first use with `g++ -O3 -shared -fPIC` into `tpu_zstd_torch/_build/`, named
by a hash of the sources and flags, under a cross-process file lock
(concurrent test workers must not race the compiler) and an atomic rename
(no process loads a half-written file).

`get_native()` returns None only where no C++ compiler exists: `g++` on
PATH, else the host compiler `nvcc` would use (`NVCC_CCBIN` or
`CUDAHOSTCXX`), else `c++`. A compiler that is found and fails raises
RuntimeError with its output: a broken build is a fault, not a route, and
so is a library that is loaded and fails (the engine's compress and the
assembler raise; only the absence of a compiler selects Python).
Every entry point but `NativeEngine` has a pure-Python fallback for the
no-compiler case.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import numpy as np

try:
    import fcntl
except ImportError:  # non-POSIX: builds are serialised within the process only
    fcntl = None

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc" / "host"
SOURCES = ("tpu_zstd_native.cpp", "tpu_zstd_engine.cpp")
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
# Filled by the first build in this process: the compiler and its seconds.
build_info: dict = {}


def find_compiler() -> str | None:
    """g++ on PATH, else nvcc's host compiler (NVCC_CCBIN, CUDAHOSTCXX),
    else c++; None when there is none."""
    for cand in ("g++", os.environ.get("NVCC_CCBIN"), os.environ.get("CUDAHOSTCXX"), "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    return None


def library_path() -> pathlib.Path:
    """Where the library for these sources and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libtzhost_{h.hexdigest()[:16]}.so"


def _build(cxx: str, so: pathlib.Path) -> None:
    """Compile to a private path, then rename into place; raise with the
    compiler's output on failure."""
    tmp = so.with_name(f".{so.name}.{os.getpid()}")
    t0 = time.perf_counter()
    run = subprocess.run([cxx, *CXX_FLAGS, *(str(SRC_DIR / s) for s in SOURCES), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build the native host library "
                           f"({run.returncode}):\n{run.stdout}\n{run.stderr}")
    os.replace(tmp, so)
    build_info.update(compiler=cxx, seconds=time.perf_counter() - t0)


def _ensure_built() -> pathlib.Path | None:
    so = library_path()
    if so.exists():
        return so
    cxx = find_compiler()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    if fcntl is None:
        _build(cxx, so)
        return so
    with open(BUILD_DIR / f"{so.name}.lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            if not so.exists():
                _build(cxx, so)
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)
    return so


def _bind(lib: ctypes.CDLL) -> None:
    P, I32, I64, U64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
    sigs = {
        "tz_xxh64": (U64, [ctypes.c_char_p, U64, U64]),
        "tz_xxh32": (ctypes.c_uint32, [ctypes.c_char_p, U64, ctypes.c_uint32]),
        "tz_huf_decode_stream": (I32, [ctypes.c_char_p, I64, P, I32, P, I64]),
        "tz_assemble_frames": (I64, [P, I64, P, P, P, P, P, I64, P, P, P, I64, P]),
        "tz_engine_create": (P, [ctypes.c_int]),
        "tz_engine_destroy": (None, [P]),
        "tz_engine_set_checksum": (None, [P, ctypes.c_int]),
        "tz_engine_set_block_size": (None, [P, ctypes.c_int]),
        "tz_engine_compress": (I64, [P, ctypes.c_char_p, I64, P, I64]),
        "tz_engine_decompress": (I64, [P, ctypes.c_char_p, I64, P, I64]),
        "tz_engine_compress_bound": (I64, [I64]),
        "tz_engine_decompressed_size": (I64, [ctypes.c_char_p, I64]),
        "tz_engine_validate": (I32, [ctypes.c_char_p, I64]),
        "tz_engine_get_stats": (None, [P, P]),
        "tz_engine_reset": (None, [P]),
        "tz_engine_error_string": (ctypes.c_char_p, [I32]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def get_native() -> ctypes.CDLL | None:
    """The native library, built on first call; None where no C++ compiler
    exists (RuntimeError where one exists and fails)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        so = _ensure_built()
        _tried = True
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        _bind(lib)
        _lib = lib
        return _lib


class NativeEngine:
    """Handle over the C engine (tz_engine_*). Use NativeEngine.create(),
    which returns None where the library cannot be had. `compress` raises
    with the engine's error string where it fails; `decompress` returns None
    for a frame the engine cannot decode, as the reference's does."""

    __slots__ = ("_lib", "_h")

    @classmethod
    def create(cls, level: int = 3, checksum: bool = False, block_size: int = 0):
        lib = get_native()
        if lib is None:
            return None
        h = lib.tz_engine_create(int(level))
        if not h:
            raise MemoryError("native engine: tz_engine_create returned no handle")
        eng = cls()
        eng._lib, eng._h = lib, h
        lib.tz_engine_set_checksum(h, 1 if checksum else 0)
        if block_size:
            lib.tz_engine_set_block_size(h, int(block_size))
        return eng

    def compress(self, data: bytes) -> bytes:
        cap = self._lib.tz_engine_compress_bound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = self._lib.tz_engine_compress(self._h, bytes(data), len(data), out, cap)
        if n < 0:
            raise RuntimeError(f"native engine: compress failed ({n}): "
                               f"{self._lib.tz_engine_error_string(int(n)).decode()}")
        return out.raw[:n]

    def decompress(self, frame: bytes, max_output: int) -> bytes | None:
        out = ctypes.create_string_buffer(max(max_output, 1))
        n = self._lib.tz_engine_decompress(self._h, bytes(frame), len(frame), out, max_output)
        return out.raw[:n] if n >= 0 else None

    def stats(self) -> tuple[int, int, int, int]:
        buf = (ctypes.c_int64 * 4)()
        self._lib.tz_engine_get_stats(self._h, buf)
        return tuple(buf)

    def reset(self) -> None:
        self._lib.tz_engine_reset(self._h)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.tz_engine_destroy(self._h)


def xxh64(data: bytes, seed: int = 0) -> int:
    lib = get_native()
    if lib is not None:
        data = bytes(data)
        return int(lib.tz_xxh64(data, len(data), seed))
    from ..format.xxhash import xxh64 as py_xxh64

    return py_xxh64(data, seed)


def xxh32(data: bytes, seed: int = 0) -> int:
    lib = get_native()
    if lib is not None:
        data = bytes(data)
        return int(lib.tz_xxh32(data, len(data), seed))
    from ..format.xxhash import xxh32 as py_xxh32

    return py_xxh32(data, seed)


def huf_decode_stream(data: bytes, dtable_packed: np.ndarray, table_log: int,
                      out_len: int) -> bytes | None:
    """Native decode of one Huffman stream (dtable_packed: symbol << 8 |
    nb_bits per state); None where the library is missing or the stream is
    malformed (the caller's Python chain then gives the diagnostics)."""
    dt = np.ascontiguousarray(dtable_packed, dtype=np.int32)
    if not 1 <= table_log <= 16 or dt.size < 1 << table_log or out_len < 0:
        raise ValueError(f"huf_decode_stream: a table of {dt.size} entries for table_log "
                         f"{table_log}, out_len {out_len}")
    lib = get_native()
    if lib is None:
        return None
    out = np.empty(out_len, dtype=np.uint8)
    data = bytes(data)
    rc = lib.tz_huf_decode_stream(data, len(data), dt.ctypes.data, int(table_log),
                                  out.ctypes.data, out_len)
    return out.tobytes() if rc == 0 else None


def assemble_frames(contents: np.ndarray, lens: np.ndarray, types: np.ndarray,
                    raw_lens: np.ndarray, firsts: np.ndarray, counts: np.ndarray,
                    headers: list[bytes], checksums: list[bytes] | None) -> bytes | None:
    """Join blocks into frames natively: frame f is headers[f], blocks
    firsts[f] .. firsts[f] + counts[f] - 1 of `contents` (each with its
    3-byte header; an RLE block's regenerated size from raw_lens) and
    checksums[f]. None where the library is missing (the caller joins in
    Python); RuntimeError where the library fails."""
    contents = np.ascontiguousarray(contents, dtype=np.uint8)
    lens, types, raw_lens, firsts, counts = (np.ascontiguousarray(a, dtype=np.int32) for a in (
        lens, types, raw_lens, firsts, counts))
    B, W = contents.shape
    if (len(lens) < B or len(types) < B or len(raw_lens) < B or len(firsts) != len(headers)
            or len(counts) != len(headers) or (checksums is not None
                                               and len(checksums) != len(headers))
            or (lens[:B] < 0).any() or (lens[:B] > W).any()
            or (firsts < 0).any() or (counts < 0).any() or (firsts + counts > B).any()):
        raise ValueError("assemble_frames: block lengths, frame spans or headers out of range")
    lib = get_native()
    if lib is None:
        return None
    hdr_blob = b"".join(headers)
    hdr_lens = np.array([len(h) for h in headers], dtype=np.int32)
    checks_blob = b"".join(checksums) if checksums is not None else None
    out_cap = int(lens.sum()) + 3 * len(lens) + len(hdr_blob) + 4 * len(headers) + 64
    out = np.empty(out_cap, dtype=np.uint8)
    n = lib.tz_assemble_frames(
        contents.ctypes.data, contents.shape[1], lens.ctypes.data, types.ctypes.data,
        raw_lens.ctypes.data, firsts.ctypes.data, counts.ctypes.data, len(headers),
        hdr_blob, hdr_lens.ctypes.data, checks_blob, out_cap, out.ctypes.data)
    if n < 0:
        raise RuntimeError(f"native assembler: tz_assemble_frames failed ({n}) "
                           f"with {out_cap} bytes of room")
    return out[:n].tobytes()
