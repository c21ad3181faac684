"""Build, load and count the port's CUDA kernels.

Each kernel source (`tpu_zstd_torch/csrc/*.cu`) compiles to an object with
its own `nvcc` process, all started together, and one more `nvcc` call
links the objects into a shared library with a plain C interface, loaded
with `ctypes`. The library lives in `tpu_zstd_torch/_build/`, named by a
hash of the sources and flags, so it is built at first use and rebuilt
whenever a source changes.
Each C entry point launches on the caller's stream and returns
`cudaGetLastError()`; `launch` raises on a non-zero code.

`launches` counts kernel launches by kernel name. A wrapper adds one to its
count where it launches its kernel and nowhere else, so a run can show that a
path really went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int
# C entry point -> argument types (pointers, sizes, stream last).
SIGNATURES = {
    "tz_roll_rows": (P, P, P, I64, I64, I32, P),
    "tz_concat_fused": (P, I32, I32, I32, P),
    "tz_greedy_segments": (P, P, I64, I32, P),
    "tz_rep_codes": (P, P, P, I32, I32, P),
    "tz_state_chain3": (P,) * 7 + (I32, P, I32) + (P,) * 4 + (I32, I32, I32, P),
    "tz_decode_huffman": (P,) * 8 + (I32,) * 5 + (P,),
    "tz_decode_sequences": (P,) * 14 + (I32,) * 8 + (P,),
    "tz_exec_sequences": (P,) * 13 + (I32,) * 6 + (P,),
    "tz_opt_steps": (P, P, P, P, P, I64, I32, I32, I32, P),
    "tz_sort_rows": (P, P, P, P, P, I32, I64, I32, P),
    "tz_match_windows": (P, P, P, P, P, I64, I32, I32, I32, I32, P),
    "tz_deposit_bits": (P, P, P, P, I64, I32, I32, P),
}

launches = {"roll": 0, "concat": 0, "greedy": 0, "rep": 0, "chain": 0,
            "decode_huf": 0, "decode_seq": 0, "exec": 0, "opt": 0, "sort": 0, "match": 0,
            "deposit": 0}

# Filled by the first build in this process: seconds spent in nvcc and the
# assembler's register / shared-memory report (`-Xptxas -v`).
build_info: dict = {}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library() -> ctypes.CDLL:
    """The kernel library, built on first use (keyed on sources + flags)."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    key = h.hexdigest()[:16]
    BUILD_DIR.mkdir(exist_ok=True)
    so = BUILD_DIR / f"libtzk_{key}.so"
    report = BUILD_DIR / f"libtzk_{key}.ptxas.txt"
    if not so.exists():
        tag = f"{key}.{os.getpid()}"
        nvcc = _nvcc()
        objs = [BUILD_DIR / f".{p.stem}.{tag}.o" for p in srcs]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(srcs, objs)]
        logs = [(p.name, proc.communicate()[0], proc.returncode) for p, proc in zip(srcs, procs)]
        failed = [f"{name} ({rc}):\n{log}" for name, log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = BUILD_DIR / f".libtzk_{tag}.so"
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}"
                               f"\n{link.stderr}")
        secs = time.perf_counter() - t0
        report.write_text("".join(log for _, log, _ in logs))
        os.replace(tmp, so)
        for o in objs:
            o.unlink()
        build_info["seconds"] = secs
    build_info["ptxas"] = report.read_text() if report.exists() else ""
    build_info["library"] = str(so)
    lib = ctypes.CDLL(str(so))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry point `entry` on the current CUDA stream, raise on a
    launch error, and count one launch of `kernel`."""
    fn = getattr(library(), entry)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    launches[kernel] += 1


def pointers(ts) -> ctypes.Array | None:
    """A host array of the tensors' data pointers, for a kernel that takes
    them by value (None for no tensors)."""
    return (ctypes.c_int64 * len(ts))(*(t.data_ptr() for t in ts)) if ts else None


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on a 16-byte boundary
    (a view at an offset): kernels that load and store 16 bytes at a time
    need that alignment."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_cuda(t: torch.Tensor, dtype, name: str) -> None:
    """Wrapper-side validation of a kernel operand."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} not supported")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
