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
one to the kernel's `launches` count.  The C entry points alone check
their arguments (sizes and launch plans): one that refuses them returns
cudaErrorInvalidValue, which `launch` raises as ValueError.  The op
wrappers in `ops/` call
`launch` only for CUDA tensors; nothing here runs for CPU tensors, and
nothing is compiled or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
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
SOURCES = ("knn.cu", "knn_topk.cu", "knn_window.cu", "fps.cu",
           "neighborhood.cu", "radius.cu", "batchnorm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_library = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue


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
            lib.dh3d_fps_max_points.argtypes = [_I, _I, _I]
            lib.dh3d_fps_max_points.restype = _I
            lib.dh3d_knn_topk_workspace.argtypes = [_I, _I, _I]
            lib.dh3d_knn_topk_workspace.restype = ctypes.c_size_t
            for k in KERNELS + (KNN_TOPK_PREPASS,):
                fn = getattr(lib, k.symbol)
                fn.argtypes = k.argtypes
                fn.restype = _I
            _library = lib
        return _library


class Kernel:
    """One kernel's C entry point and the count of its launches."""

    def __init__(self, name: str, symbol: str, argtypes, defaults=()):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [_P]  # + the stream
        self.defaults = tuple(defaults)  # of the last arguments (a plan)
        self.launches = 0
        self._fn = None  # the entry point, once the library is loaded

    def launch(self, device: torch.device, *args) -> None:
        """Launch on `device`'s current stream; arguments left off the end
        take `defaults`.  Raises ValueError when the entry point refuses
        the arguments, RuntimeError on another CUDA error."""
        missing = len(self.argtypes) - 1 - len(args)
        if 0 < missing <= len(self.defaults):
            args += self.defaults[len(self.defaults) - missing:]
        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(library(), self.symbol)
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        if torch.cuda.current_device() == index:
            err = fn(*args, _raw_stream(index))
        else:  # a launch goes to the current device's streams
            with torch.cuda.device(index):
                err = fn(*args, _raw_stream(index))
        if err == CUDA_ERROR_INVALID_VALUE:
            sizes = [a for t, a in zip(self.argtypes, args) if t is _I]
            raise ValueError(
                f"{self.name} kernel: its entry point refused the sizes and "
                f"plan {sizes} (invalid argument)")
        if err != 0:
            raise RuntimeError(
                f"{self.name} kernel: CUDA error {err} "
                f"({library().dh3d_error_string(err).decode()}) at launch")
        self.launches += 1


def _raw_stream(index: int) -> int:
    """The current stream of CUDA device `index`, as a pointer."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:  # without building a Stream object
        return get(index)
    return torch.cuda.current_stream(index).cuda_stream


KNN = Kernel("knn", "dh3d_knn", [_P, _P, _P, _P, _I, _I, _I, _I])
# G: sizes, then the plan (merge)
KNN_TOPK = Kernel("knn_topk", "dh3d_knn_topk", [_P] * 5 + [_I] * 5)
# G's pre-pass alone, for timing it; not a kernel of its own (G launches it)
KNN_TOPK_PREPASS = Kernel("knn_topk_prepass", "dh3d_knn_topk_prepass",
                          [_P, _P, _P, _I, _I, _I])
# H: sizes, k, the band's width (window), then the plan (lanes a query;
# one when left off)
KNN_WINDOW = Kernel("knn_window", "dh3d_knn_window", [_P] * 4 + [_I] * 6,
                    defaults=(1,))
FPS = Kernel("fps", "dh3d_fps", [_P, _P, _I, _I, _I, _I, _I])
# C and D: sizes, then the plan (vec, lanes, passes)
WEIGHTED_SUM = Kernel("weighted_sum", "dh3d_weighted_sum",
                      [_P, _P, _P, _P] + [_I] * 9)
FLEX_MOMENTS = Kernel("flex_moments", "dh3d_flex_moments",
                      [_P, _P, _P, _P] + [_I] * 9)
# C's bf16 case: bf16 features (the bf16 compute_dtype), f32 moments
FLEX_MOMENTS_BF16 = Kernel("flex_moments_bf16", "dh3d_flex_moments_bf16",
                           [_P, _P, _P, _P] + [_I] * 9)
NEIGHBOR_MAX = Kernel("neighbor_max", "dh3d_neighbor_max",
                      [_P, _P, _P, _P, _P] + [_I] * 8)
WEIGHTED_SUM_BWD = Kernel("weighted_sum_backward", "dh3d_weighted_sum_bwd",
                          [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
FLEX_MOMENTS_BWD = Kernel("flex_moments_backward", "dh3d_flex_moments_bwd",
                          [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
# E's bf16 case: the bf16 feature gradient of C's bf16 case
FLEX_MOMENTS_BWD_BF16 = Kernel(
    "flex_moments_backward_bf16", "dh3d_flex_moments_bwd_bf16",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
NEIGHBOR_MAX_BWD = Kernel("neighbor_max_backward", "dh3d_neighbor_max_bwd",
                          [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I])
# I: the loader's radius count: M, the radius, then the plan (the key split)
RADIUS_COUNT = Kernel("radius_count", "dh3d_radius_count",
                      [_P, _P, _I, _D, _I])
# J: train-mode BatchNorm (+ ReLU), one entry point a pass: sizes, then
# the plan (channels a thread, row slices)
BN_STATS = Kernel("batch_norm_stats", "dh3d_bn_stats", [_P] * 3 + [_I] * 4)
BN_FORWARD = Kernel("batch_norm_forward", "dh3d_bn_forward",
                    [_P] * 8 + [_I, _I, _D, _D, _D] + [_I] * 4)
BN_GRAD_SUMS = Kernel("batch_norm_grad_sums", "dh3d_bn_grad_sums",
                      [_P] * 6 + [_I] * 5)
BN_GRAD_DX = Kernel("batch_norm_grad_dx", "dh3d_bn_grad_dx",
                    [_P] * 11 + [_I] * 5)
KERNELS = (KNN, KNN_TOPK, KNN_WINDOW, FPS, WEIGHTED_SUM, FLEX_MOMENTS,
           FLEX_MOMENTS_BF16, NEIGHBOR_MAX, WEIGHTED_SUM_BWD,
           FLEX_MOMENTS_BWD, FLEX_MOMENTS_BWD_BF16, NEIGHBOR_MAX_BWD,
           RADIUS_COUNT, BN_STATS, BN_FORWARD, BN_GRAD_SUMS, BN_GRAD_DX)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def add_counts(launches: dict) -> None:
    """Add {kernel name: n} to the kernels' counts (n may be negative): a
    CUDA graph's replay adds the launches its capture recorded."""
    for k in KERNELS:
        k.launches += launches.get(k.name, 0)


def fps_max_points(device: torch.device, cluster: int = 8,
                   threads: int = 128) -> int:
    """The largest cloud the FPS kernel samples on `device` with `cluster`
    blocks of `threads` threads a cloud (8 blocks of 128, the default, is
    the most `farthest_point_sample` takes); 0 for a plan it refuses."""
    return int(library().dh3d_fps_max_points(device.index or 0, cluster,
                                             threads))


def topk_workspace_bytes(B: int, Nq: int, Nk: int) -> int:
    """Bytes of scratch kernel G needs (its sorted key table, chunk and
    group boxes, the order and positions of cross queries); 0 for sizes it
    refuses."""
    return int(library().dh3d_knn_topk_workspace(B, Nq, Nk))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device `device_index`."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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
