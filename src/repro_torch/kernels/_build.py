"""Build and bind the hand-written Hopper kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface (``<name>_launch``
returning ``cudaGetLastError()`` as an int, and ``<name>_error_string``)
and is compiled by ``nvcc`` into its own shared library under
``build/repro_torch/`` at the repository root, named by a hash of its
sources, so an unchanged kernel is never rebuilt.  All missing libraries
are compiled together — one ``nvcc`` process per source, started at once —
the first time any kernel is launched (or when :func:`build_all` is called
directly).  Libraries are loaded with ``ctypes``; every pointer and the
stream are passed as ``c_void_p``.

Nothing here runs at import time: this module imports on machines without
``nvcc`` or a GPU, where the kernels' custom ops run their plain versions
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

#: every kernel of the package by name (filled as wrapper modules import)
KERNELS: Dict[str, "Kernel"] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" \
        / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build only where the CUDA toolkit is installed")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / source, CSRC / "common.cuh"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Compile every missing kernel library in parallel; returns
    ``{source: seconds}`` for the ones built now (empty when all were
    built already).  Raises with the compiler's output on any failure;
    the ``-Xptxas -v`` report of each build is kept beside its library
    as ``<lib>.log``."""
    sources = sorted(p.name for p in CSRC.glob("*.cu")) \
        if sources is None else list(sources)
    todo = [(s, _lib_path(s)) for s in sources if not _lib_path(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    took: Dict[str, float] = {}
    failures: List[str] = []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        took[src] = time.perf_counter() - t0
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"--- nvcc {src} (rc {proc.returncode})\n{text}")
            continue
        lib.with_suffix(".so.log").write_text(text)
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return took


class Kernel:
    """One hand-written kernel: its source, its lazily built and loaded C
    entry point, and its launch count.

    ``launches`` counts launches of the CUDA kernel (incremented by
    :meth:`launch` only); ``plain_calls`` counts calls of the kernel's
    custom op that ran its plain PyTorch version because their tensors lay
    on the CPU."""

    def __init__(self, name: str, source: str, argtypes: Sequence[type]):
        self.name = name
        self.source = source
        self.argtypes = list(argtypes)
        self.launches = 0
        self.plain_calls = 0
        self._fn = None
        self._err = None
        KERNELS[name] = self

    def _load(self):
        lib_path = _lib_path(self.source)
        if not lib_path.exists():
            build_all()
        lib = ctypes.CDLL(str(lib_path))
        fn = getattr(lib, f"{self.name}_launch")
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def launch(self, *args) -> None:
        """Call the C entry point (it launches on the stream passed as its
        last argument); raises if the launch was refused."""
        if self._fn is None:
            self._load()
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed ({rc}: "
                f"{self._err(rc).decode()})")
        self.launches += 1


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.plain_calls = 0


def ptr(t) -> ctypes.c_void_p:
    """The address of ``t``'s data as a kernel argument.  Refuses a tensor
    with no real storage behind it — a fake or meta tensor of a trace, a
    subclass without storage — before any pointer is formed: its
    ``data_ptr`` is no address a kernel may read or write."""
    from torch._subclasses.fake_tensor import is_fake

    if is_fake(t) or t.is_meta or not torch._C._has_storage(t):
        raise ValueError(
            f"a kernel argument of shape {tuple(t.shape)} on {t.device} has "
            "no storage (a fake or meta tensor): no pointer is formed for "
            "it")
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA ``device`` (cached)."""
    device = torch.device(device)
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


#: element types the kernels are instantiated for, by their C code
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype) -> int:
    if dtype not in DTYPE_CODE:
        raise TypeError(f"kernel dtype {dtype} not supported")
    return DTYPE_CODE[dtype]


def per_id(v, n: int, device) -> torch.Tensor:
    """A fence operand as an ``(n,)`` int32 tensor on ``device``: a scalar
    is filled on the device (no host copy per call), a per-id tensor is
    broadcast."""
    if not isinstance(v, torch.Tensor):
        return torch.full((n,), int(v), dtype=torch.int32, device=device)
    return v.to(device=device, dtype=torch.int32).expand(n).contiguous()


def fence_operand(v, n: int, device):
    """A fence operand as the kernels take it: an int stays an int, passed
    by value (nothing is allocated or launched for it); a tensor becomes
    one ``(n,)`` int32 value per id or row on ``device``."""
    return per_id(v, n, device) if isinstance(v, torch.Tensor) else int(v)


def fence_args(v):
    """The C arguments ``(pointer, scalar)`` of a :func:`fence_operand`:
    a tensor's pointer and 0, or NULL and the int."""
    return (ptr(v), 0) if isinstance(v, torch.Tensor) \
        else (ctypes.c_void_p(None), v)


def check_device(name: str, t) -> None:
    """A kernel's custom op runs its CUDA kernel for CUDA tensors and its
    plain version for CPU tensors; any other device is refused here, before
    the op is reached."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def split_fence(v):
    """A :func:`fence_operand` as a custom op takes it: ``(tensor or None,
    int)`` — a tensor fence and 0, or None and the int by value."""
    return (v, 0) if isinstance(v, torch.Tensor) else (None, int(v))


def join_fence(t, v: int):
    """Inverse of :func:`split_fence`."""
    return t if t is not None else v


def check_cuda(name: str, *tensors) -> None:
    """A kernel's operands must all be contiguous tensors on one CUDA
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             "is not contiguous")
