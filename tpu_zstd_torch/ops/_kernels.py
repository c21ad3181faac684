"""Build, load and count the port's CUDA kernels.

All kernel sources (`tpu_zstd_torch/csrc/*.cu`) compile with ONE `nvcc` call
into a shared library with a plain C interface, loaded with `ctypes`. The
library lives in `tpu_zstd_torch/_build/`, named by a hash of the sources and
flags, so it is built at first use and rebuilt whenever a source changes.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int
# C entry point -> argument types (pointers, sizes, stream last).
SIGNATURES = {
    "tz_roll_rows": (P, P, P, I64, I64, I32, P),
    "tz_concat_varlen": (P, P, P, P, I32, I32, I32, I32, P),
    "tz_greedy_segments": (P, P, I64, I32, P),
    "tz_rep_codes": (P, P, I32, I32, P),
    "tz_state_chain3": (P,) * 11 + (I32, I32, I32, P),
}

launches = {"roll": 0, "concat": 0, "greedy": 0, "rep": 0, "chain": 0}

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
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    key = h.hexdigest()[:16]
    BUILD_DIR.mkdir(exist_ok=True)
    so = BUILD_DIR / f"libtzk_{key}.so"
    report = BUILD_DIR / f"libtzk_{key}.ptxas.txt"
    if not so.exists():
        tmp = BUILD_DIR / f".libtzk_{key}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(p) for p in srcs]]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        report.write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
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


def check_cuda(t: torch.Tensor, dtype, name: str) -> None:
    """Wrapper-side validation of a kernel operand."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} not supported")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
