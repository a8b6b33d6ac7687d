"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each kernel source compiles with its own nvcc process, all started
together, and one more nvcc links the objects into ONE shared library with a
plain C interface, loaded with ctypes; no PyTorch header is compiled, so a
build takes seconds. The library lands in `build/s2d_tpu_torch/` at the root of
the checkout, named by a hash of the sources and flags, and is built at the
first `library()` call, never at import. Without nvcc, or when nvcc fails,
`library()` raises with the compiler's own message.

Every launcher takes device pointers, sizes, strides and the CUDA stream,
and returns `cudaGetLastError()` as an int.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "s2d_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# argtypes of every launcher: pointers and the stream as c_void_p, or
# ctypes would pass them as 32-bit ints and cut them
SIGNATURES = {
    # value, level_info (host), locations, weights, out, B, S, M, D, Lq, L, P, stream
    "s2d_msda_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # value, level_info, locations, weights, grad_out, grad_value, grad_loc,
    # grad_weights, B, S, M, D, Lq, L, P, stream
    "s2d_msda_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # benefit, eps list, out, problems, N, Q, phases, max_iters, stream
    "s2d_auction": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # q, k, v, mask, workspace, out, BH, Q, K, Dh, H, mask strides (b, h, q, k),
    # scale, keys a chunk, stream
    "s2d_masked_attention_fwd": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _F, _I, _P,
    ),
    # iou, labels (int64), scratch (N >= ops/nms.WALK_FROM), keep, N, threshold, stream
    "s2d_greedy_nms": (_P, _P, _P, _P, _I, _F, _P),
    # N: the scratch words s2d_greedy_nms needs
    "s2d_greedy_nms_scratch_words": (_I,),
    # stream: an empty kernel, the launch floor
    "s2d_empty_launch": (_P,),
    # variant, vt, ya, wy0, wy1, x0, wx0, wx1, out, ng, W*d, k, gqp, W, d, stream
    "s2d_msda_ablate": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}

_LIB: ctypes.CDLL | None = None


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or DEFAULT_CUDA_HOME
    candidate = os.path.join(home, "bin", "nvcc")
    return candidate if os.path.exists(candidate) else None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libs2d_kernels_{digest.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
            f"default {DEFAULT_CUDA_HOME}); the s2d_tpu_torch CUDA kernels "
            "need the CUDA toolkit to build"
        )
    target.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: a concurrent or cut build never
    # leaves a half-written library under the final name
    with tempfile.TemporaryDirectory(dir=target.parent) as work:
        objects, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-o", obj, str(src)]
            objects.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        failed = []
        for cmd, proc in procs:
            output = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{output}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(work, target.name)
        cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *objects]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, target)


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if this source hash has no
    build yet."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = _library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def stream_handle(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


@functools.lru_cache(maxsize=8)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device: K3's wrapper sizes its key
    chunks by it (K1's launcher asks the runtime itself)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count
