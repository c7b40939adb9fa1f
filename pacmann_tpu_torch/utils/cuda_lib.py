"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each kernel lives in csrc/<name>.cu behind a plain C entry point that takes
device pointers, sizes and a cudaStream_t, launches, and returns
cudaGetLastError(). It is compiled on first use for sm_90a into a shared
library under pacmann_tpu_torch/build/ (git-ignored), named by a hash of
its source and of csrc/'s headers so that an edited kernel is rebuilt, and
loaded once per process.
The host tier's C++ (csrc/host/<name>.cpp, native_lib.py's AES-NI and
AVX2 kernels) is built the same way by load_host, with the host's C++
compiler.
Nothing here runs at import time: machines without nvcc import the
package and use the plain torch versions on CPU tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
HOST_CSRC = CSRC / "host"
BUILD = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-maes", "-mavx2",
              "-mfma"]

_LIBS: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _host_cxx() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found: the host library cannot be "
                       "built")


def source_digest(src: Path) -> str:
    """Hash of a source and of every header in its directory (a source may
    include any of them), so that editing either rebuilds the library."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def _build(name: str, src: Path, compiler: list) -> tuple[Path, str]:
    """Compile src with `compiler` (its command before -o) into
    BUILD/lib<name>-<digest>.so unless that build exists. Returns the
    library's path and the compiler's diagnostics ("" for a build found)."""
    so = BUILD / f"lib{name}-{source_digest(src)}.so"
    if so.exists():
        return so, ""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([*compiler, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(compiler[0]).name} failed for "
                           f"{src.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    build_seconds[name] = time.perf_counter() - t0
    return so, proc.stderr


def load(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its build is missing, load it, cache it."""
    if name in _LIBS:
        return _LIBS[name]
    so, notes = _build(name, CSRC / f"{name}.cu",
                       [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v"])
    if notes:
        (BUILD / f"{name}.ptxas.txt").write_text(notes)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """Compile csrc/host/<name>.cpp for this CPU (HOST_FLAGS: AES-NI,
    AVX2, FMA) if its build is missing, load it, cache it. Raises
    RuntimeError where no C++ compiler is found or the build fails."""
    key = f"host/{name}"
    if key in _LIBS:
        return _LIBS[key]
    so, _ = _build(name, HOST_CSRC / f"{name}.cpp", [_host_cxx(), *HOST_FLAGS])
    lib = ctypes.CDLL(str(so))
    _LIBS[key] = lib
    return lib


def function(lib_name: str, fn_name: str, argtypes: list):
    """A C entry point of csrc/<lib_name>.cu with its argument types set
    (c_void_p for every pointer and the stream, so none is cut to 32 bits)
    and an int (cudaError_t) result."""
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t from a launch entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def default_device(x, device=None) -> torch.device:
    """Where an entry point given `x` runs: `device` if given, else a
    tensor's own device, else CUDA. Raises where CUDA is asked for and not
    available: the CPU is taken only when asked for."""
    if device is not None:
        dev = torch.device(device)
    elif isinstance(x, torch.Tensor):
        dev = x.device
    else:
        dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


@contextlib.contextmanager
def fp32_matmul(device: torch.device):
    """Full fp32 matrix products on a CUDA device while the block runs,
    whatever the caller's TF32 setting (the JAX package's
    Precision.HIGHEST); nothing to do on the CPU."""
    if device.type != "cuda":
        yield
        return
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = prev


def require_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_shape(t: torch.Tensor, name: str, shape: tuple,
                  device: torch.device):
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, "
                         f"expected {shape} on {device}")
