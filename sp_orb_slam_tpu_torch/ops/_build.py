"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is one source `sp_orb_slam_tpu_torch/csrc/<name>.cu` with a plain
C entry point.  On first use it is compiled by `nvcc` for Hopper (`sm_90a`)
into `build/torch_kernels/lib<name>.so` at the root of the checkout and
loaded with `ctypes`: no PyTorch headers, so a build takes seconds.  A
library is rebuilt when its source is newer.  Nothing here runs at import
time, so the package imports on a machine without `nvcc` or a card.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns `cudaGetLastError()`; `launch`
raises on a non-zero code and only then counts the launch in `LAUNCHES`,
or, inside `captured()` (a CUDA graph's capture, which runs nothing), in
the capture's own counts, which `add_launches` adds on each replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
KERNELS = ("pair1t", "pair1", "nms", "cov", "match", "desc_sparse",
           "desc_dense", "noop")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches of each kernel by its wrapper (a plain count: set an entry to 0,
# run, read it back; `launch` adds under `_lock`)
LAUNCHES = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_local = threading.local()  # `captured`'s counts, per thread
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return (not os.path.exists(lib) or os.path.getmtime(lib)
            < os.path.getmtime(os.path.join(CSRC, f"{name}.cu")))


def build(names=KERNELS, force: bool = False) -> dict[str, str]:
    """Compile the named kernels, all `nvcc` processes at once.

    Returns {name: compiler output} (the `-Xptxas -v` register, shared
    memory and spill report) for each library it built; raises with the
    compiler output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not (force or _stale(name)):
            continue
        tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, _lib_path(name))  # atomic: readers never see half
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def function(name: str, symbol: str, argtypes) -> object:
    """The C entry point `symbol` of kernel library `name` (built on first
    use), with its argument types declared and an int return code."""
    key = (name, symbol)
    with _lock:
        if key not in _fns:
            if name not in _libs:
                if _stale(name):
                    build([name])
                _libs[name] = ctypes.CDLL(_lib_path(name))
            fn = getattr(_libs[name], symbol)
            fn.argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
            fn.restype = ctypes.c_int
            _fns[key] = fn
        return _fns[key]


def check(t: torch.Tensor, what: str, dtype: torch.dtype, shape) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`
    (None in `shape` matches any size)."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(
            s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def launch(name: str, symbol: str, argtypes, *args,
           device: torch.device) -> None:
    """Call a C entry point on the current stream of `device`, raise on a
    launch error, and count the launch."""
    fn = function(name, symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel: {symbol} returned CUDA error "
                           f"{err}")
    with _lock:  # the online mode's threads all launch
        counts = getattr(_local, "captured", None)
        (LAUNCHES if counts is None else counts)[name] += 1


@contextlib.contextmanager
def captured():
    """Inside the block, this thread's launches are counted in the dict it
    yields and not in `LAUNCHES`: a CUDA graph's capture enqueues them and
    the card runs none of them.  Other threads count as usual."""
    counts = dict.fromkeys(KERNELS, 0)
    _local.captured = counts
    try:
        yield counts
    finally:
        _local.captured = None


def add_launches(counts: dict) -> None:
    """Count launches that a graph's replay ran (the dict `captured`
    yielded)."""
    with _lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


def noop(device: torch.device) -> None:
    """Launch the empty kernel of csrc/noop.cu through `launch`: the floor
    under the time of every kernel launched the same way."""
    launch("noop", "noop_launch", (), device=device)
