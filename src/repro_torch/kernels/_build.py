"""Build and bind the hand-written CUDA kernels under ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/repro_torch/`` at the repository root, at first use, then bound with
``ctypes``.  Library names carry a hash of the source, so an edited kernel
is rebuilt and a stale build is never loaded.  :func:`build_all` starts one
``nvcc`` per source at once (the whole build costs the slowest file, not the
sum).

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after the launch; wrappers call it through
:func:`launch`, which sets the tensors' device around the call and turns a
non-zero code into an exception.  Nothing here is imported or built when a
module is imported: the CPU test suite imports every module on a machine
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_longlong

#: C signature (argtypes) of each kernel library's entry point.
SIGNATURES = {
    "cam_match": ("cam_match_launch", (_P, _P, _P, _I, _I, _I, _P)),
    "bit_transpose": ("bit_transpose_launch", (_P, _P, _I, _I, _P)),
    "bitmap_query": ("bitmap_query_launch", (_P, _P, _P, _P, _I, _I, _P)),
    "bulk_program": ("bulk_program_launch",
                     (_P,) * 7 + (_I,) * 8 + (_P,)),
    "bulk_program_stacked": ("bulk_program_launch",
                             (_P,) * 7 + (_I,) * 8 + (_P,)),
    "bulk_program_plan": ("bulk_program_plan", (_I,) * 7 + (_P,)),
    "flash_attention_fwd": ("flash_attention_fwd_launch",
                            (_P,) * 5 + (_I,) * 11 + (_P,)),
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            (_P,) * 10 + (_I,) * 11 + (_P,)),
}

#: which source file holds each kernel
SOURCES = {"cam_match": "cam_match.cu", "bit_transpose": "bit_transpose.cu",
           "bitmap_query": "bitmap_ops.cu", "bulk_program": "bitmap_ops.cu",
           "bulk_program_stacked": "bitmap_ops.cu",
           "bulk_program_plan": "bitmap_ops.cu",
           "flash_attention_fwd": "attention.cu",
           "flash_attention_bwd": "attention.cu"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}       # source file -> loaded library
_fns: dict[str, object] = {}             # kernel -> bound entry point


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (needs the CUDA toolkit: PATH or "
                      "CUDA_HOME)")


def _target(src: str) -> Path:
    digest = hashlib.sha1((CSRC / src).read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(src).stem}-{digest}.so"


def _start(src: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = _target(src)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build_all(sources=None) -> str:
    """Compile every (or the named) kernel source not yet built, one
    ``nvcc`` process per file, all started together.  Returns the compilers'
    combined output (``ptxas`` register and shared-memory report); raises
    :class:`KernelError` naming the file that did not compile."""
    srcs = sorted(set(SOURCES.values()) if sources is None else set(sources))
    with _lock:
        jobs = [(s, j) for s in srcs if (j := _start(s)) is not None]
        report, failed = [], []
        for src, (out, tmp, proc) in jobs:
            text, _ = proc.communicate()
            report.append(f"--- {src}\n{text}")
            if proc.returncode != 0:
                failed.append(src)
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)          # atomic: no half-written .so
    if failed:
        raise KernelError(f"nvcc failed for {failed}:\n" + "\n".join(report))
    return "\n".join(report)


def library(kernel: str):
    """The bound C entry point of ``kernel`` (building and loading its
    source at first use)."""
    fn = _fns.get(kernel)
    if fn is not None:
        return fn
    src = SOURCES[kernel]
    build_all([src])
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = _libs[src] = ctypes.CDLL(str(_target(src)))
        fn_name, argtypes = SIGNATURES[kernel]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[kernel] = fn
    return fn


def check(rc: int, kernel: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        raise KernelError(f"{kernel}: CUDA launch failed with error {rc}")


def launch(kernel: str, device, *args) -> None:
    """Call ``kernel``'s C entry with ``args`` and the current stream of
    ``device``, under ``device`` (the runtime's current device for the
    call, so the C side works on the device its pointers and stream belong
    to, in any thread), then raise on a CUDA error.  Every wrapper launches
    through here."""
    import torch
    fn = library(kernel)
    with torch.cuda.device(device):
        rc = fn(*args, stream(device))
    check(rc, kernel)


def stream(device) -> ctypes.c_void_p:
    """The current PyTorch CUDA stream of ``device``, as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def on_card(kernel: str, *tensors) -> bool:
    """True when every tensor lies on one CUDA device (the wrapper launches
    the kernel), False when all lie on the CPU (the wrapper runs the plain
    version); anything else raises."""
    kinds = {t.device for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"{kernel}: tensors on several devices {kinds}")
    kind = next(iter(kinds)).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{kernel}: no kernel or plain version for device "
                         f"type {kind!r}")
    return kind == "cuda"


def on_meta(kernel: str, *tensors) -> bool:
    """True when every tensor lies on the meta device (a dry-run trace: a
    wrapper that has a meta route checks its arguments and returns outputs
    of the kernel's shapes, launching nothing and running no plain
    version), False when none does; a mix raises."""
    kinds = {t.device.type == "meta" for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"{kernel}: meta and real tensors mixed")
    return kinds == {True}


def require(kernel: str, cond: bool, what: str) -> None:
    """Argument check of a kernel wrapper."""
    if not cond:
        raise ValueError(f"{kernel}: {what}")
