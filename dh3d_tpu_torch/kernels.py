"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

The sources are compiled at first use with `nvcc`, one process per source,
all started together, and linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), which `ctypes`
loads.  The library's file name carries a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  It lands in `build/kernels/` at the root of the checkout.

Every kernel has one `Kernel` object here.  Its `launch` passes device
pointers and sizes to the C entry point together with PyTorch's current
stream, raises if the entry point returns a CUDA error, and only then adds
one to the kernel's `launches` count.  The op wrappers in `ops/` call
`launch` only for CUDA tensors; nothing here runs for CPU tensors, and
nothing is compiled or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")
SOURCES = ("knn.cu", "fps.cu", "neighborhood.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_library = None
_P = ctypes.c_void_p
_I = ctypes.c_int


def find_nvcc() -> str:
    """`nvcc` from PATH, else from $CUDA_HOME or the default toolkit
    location; raises RuntimeError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "dh3d_tpu_torch CUDA kernels cannot be built")


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libdh3d_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float]:
    """Compile `csrc/*.cu` unless the library for these sources exists.

    Every source is compiled by its own nvcc process, all at once; the
    objects are then linked into the library.  Returns (library path,
    seconds spent compiling and linking; 0.0 when reused).  Raises
    RuntimeError with the compiler's output when nvcc fails."""
    path = library_path()
    if os.path.isfile(path):
        return path, 0.0
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{path}.{os.path.splitext(s)[0]}.{os.getpid()}.o"
            for s in SOURCES]
    t0 = time.perf_counter()
    procs = []
    for src, obj in zip(SOURCES, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, src),
               "-o", obj]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, proc in procs:  # wait for every process before raising
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}\n{err}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}): "
                               f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _library
    with _lock:
        if _library is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            lib.dh3d_error_string.argtypes = [_I]
            lib.dh3d_error_string.restype = ctypes.c_char_p
            lib.dh3d_fps_smem_limit.argtypes = [_I]
            lib.dh3d_fps_smem_limit.restype = _I
            for k in KERNELS:
                fn = getattr(lib, k.symbol)
                fn.argtypes = k.argtypes
                fn.restype = _I
            _library = lib
        return _library


class Kernel:
    """One kernel's C entry point and the count of its launches."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [_P]  # + the stream
        self.launches = 0

    def launch(self, device: torch.device, *args) -> None:
        """Launch on `device`'s current stream; raise on a CUDA error."""
        lib = library()
        fn = getattr(lib, self.symbol)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name} kernel: CUDA error {err} "
                f"({lib.dh3d_error_string(err).decode()}) at launch")
        self.launches += 1


KNN = Kernel("knn", "dh3d_knn", [_P, _P, _P, _P, _I, _I, _I, _I])
FPS = Kernel("fps", "dh3d_fps", [_P, _P, _I, _I, _I])
WEIGHTED_SUM = Kernel("weighted_sum", "dh3d_weighted_sum",
                      [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
NEIGHBOR_MAX = Kernel("neighbor_max", "dh3d_neighbor_max",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I])
WEIGHTED_SUM_BWD = Kernel("weighted_sum_backward", "dh3d_weighted_sum_bwd",
                          [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
NEIGHBOR_MAX_BWD = Kernel("neighbor_max_backward", "dh3d_neighbor_max_bwd",
                          [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I])
KERNELS = (KNN, FPS, WEIGHTED_SUM, NEIGHBOR_MAX, WEIGHTED_SUM_BWD,
           NEIGHBOR_MAX_BWD)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def fps_smem_limit(device: torch.device) -> int:
    """Bytes of dynamic shared memory the FPS kernel may use on `device`."""
    return int(library().dh3d_fps_smem_limit(device.index or 0))


def on_cuda(*tensors: torch.Tensor) -> bool:
    """Where a kernelled op runs: False for CPU tensors (the plain
    version), True for CUDA tensors (the kernel).  Raises for tensors on
    different devices or on any other device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {dev}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple) -> None:
    """Raise ValueError unless `t` has `dtype`, is contiguous and matches
    `shape` (an entry of None matches any size)."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
