"""Simulated closed-source CUDA-accelerated libraries (Guardian §4.1, §7.7).

The paper's hardest interception case: high-level library calls
(``cublasIsamax`` et al.) *implicitly* issue CUDA runtime/driver calls —
mallocs, copies, kernel launches — that must not escape the manager.

These classes model that behaviour: each high-level entry point performs the
same implicit call pattern the paper measured (Table 6), all through the
tenant's :class:`GuardianClient`, so the trace reproduces the table and the
kernels inside run sandboxed.  The kernel bodies are plain PyTorch
functions registered at ``create()`` time via ``module_load``; the
sandboxer traces each into its aten graph and fences it (the paper
extracts and patches the library's PTX offline).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.interception import DevicePtr, GuardianClient


# --------------------------------------------------------------------------
# "Library" kernels: signature fn(arena, *args) -> (arena, out).
# They address device memory via raw integer slot offsets (ptrs) — exactly
# the unsafe pattern the sandboxer must fence.  Indices are int32, as the
# reference's are; ``index_select`` takes them as they are and has
# ``jnp.take``'s semantics under the sandbox (NaN past the arena).
# --------------------------------------------------------------------------

def _iota(n: int, arena: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=arena.device)


def _load(arena: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return arena.index_select(0, idx)


def _k_isamax(arena, x_ptr, n: int):
    x = _load(arena, x_ptr + _iota(n, arena))
    return arena, torch.argmax(torch.abs(x)).to(torch.int32)


def _k_dot(arena, x_ptr, y_ptr, out_ptr, n: int):
    ii = _iota(n, arena)
    d = torch.dot(_load(arena, x_ptr + ii), _load(arena, y_ptr + ii))
    arena[out_ptr.reshape(1)] = d.reshape(1)
    return arena, d


def _k_axpby(arena, x_ptr, y_ptr, alpha, beta, n: int):
    ii = _iota(n, arena)
    x = _load(arena, x_ptr + ii)
    y = _load(arena, y_ptr + ii)
    arena[y_ptr + ii] = alpha * x + beta * y
    return arena, None


def _k_gemm(arena, a_ptr, b_ptr, c_ptr, m: int, k: int, n: int):
    a = _load(arena, a_ptr + _iota(m * k, arena)).reshape(m, k)
    b = _load(arena, b_ptr + _iota(k * n, arena)).reshape(k, n)
    arena[c_ptr + _iota(m * n, arena)] = (a @ b).reshape(-1)
    return arena, None


def _k_fft_c2c(arena, x_ptr, out_ptr, n: int):
    """Complex-interleaved FFT: 2n real slots in, 2n real slots out."""
    ii = _iota(2 * n, arena)
    buf = _load(arena, x_ptr + ii)
    f = torch.fft.fft(torch.complex(buf[0::2], buf[1::2]))
    arena[out_ptr + ii] = torch.view_as_real(f).reshape(-1)
    return arena, None


def _k_csr_spmv(arena, vals_ptr, cols_ptr, x_ptr, y_ptr, nnz: int, n: int):
    """Sparse matvec where the *column indices live in device memory* —
    a data-dependent gather whose indices are themselves tenant data.  This
    is the paper's nastiest case: the address register is loaded from
    memory before the ld.global."""
    kk = _iota(nnz, arena)
    vals = _load(arena, vals_ptr + kk)
    cols = _load(arena, cols_ptr + kk).to(torch.int32)
    xs = _load(arena, x_ptr + cols)                 # double indirection
    rows = kk % n
    y = torch.zeros(n, dtype=arena.dtype, device=arena.device)
    y.index_add_(0, rows, vals * xs)
    arena[y_ptr + _iota(n, arena)] = y
    return arena, None


def _k_noop(arena, p, n: int):
    return arena, None


class GrdBLAS:
    """cuBLAS stand-in.  Mirrors the implicit-call patterns of Table 6."""

    def __init__(self, client: GuardianClient):
        self.client = client
        self._workspace: Optional[DevicePtr] = None

    def create(self) -> "GrdBLAS":
        """cublasCreate: 3 mallocs, 18 event-creates, 2 frees, a launch and
        a memcpy (Table 6 row 1)."""
        c = self.client
        c.trace.push_context("cublasCreate")
        try:
            ws = [c.malloc(16) for _ in range(3)]
            for _ in range(18):
                c.event_create()
            c.free(ws[1])
            c.free(ws[2])
            c.memcpy_h2d(ws[0], np.zeros(16, np.float32))
            c.launch_kernel("grdblas.init", ptrs=[ws[0]], args=(16,))
            self._workspace = ws[0]
        finally:
            c.trace.pop_context()
        return self

    def isamax(self, x: DevicePtr, n: int):
        c = self.client
        c.trace.push_context("cublasIsamax")
        try:
            c.stream_get_capture_info()
            c.stream_get_capture_info()
            out = c.launch_kernel("grdblas.isamax", ptrs=[x], args=(n,))
            c.event_record()
            c.synchronize()
            c.memcpy_d2h(x, 0)  # result fetch (0-slot marker read)
        finally:
            c.trace.pop_context()
        c._manager.run_queued()
        return out

    def dot(self, x: DevicePtr, y: DevicePtr, out: DevicePtr, n: int):
        c = self.client
        c.trace.push_context("cublasDdot")
        try:
            c.stream_get_capture_info()
            c.stream_get_capture_info()
            c.launch_kernel("grdblas.dot_pre", ptrs=[x], args=(n,))
            res = c.launch_kernel("grdblas.dot", ptrs=[x, y, out], args=(n,))
            c.event_record()
            c.memcpy_d2h(out, 1)
        finally:
            c.trace.pop_context()
        return res

    def axpby(self, alpha: float, x: DevicePtr, beta: float, y: DevicePtr,
              n: int) -> None:
        c = self.client
        c.trace.push_context("cublasAxpby")
        try:
            c.launch_kernel("grdblas.axpby", ptrs=[x, y],
                            args=(torch.tensor(alpha, dtype=torch.float32),
                                  torch.tensor(beta, dtype=torch.float32),
                                  n))
        finally:
            c.trace.pop_context()

    def gemm(self, a: DevicePtr, b: DevicePtr, out: DevicePtr,
             m: int, k: int, n: int) -> None:
        c = self.client
        c.trace.push_context("cublasSgemm")
        try:
            c.stream_get_capture_info()
            c.launch_kernel("grdblas.gemm", ptrs=[a, b, out], args=(m, k, n))
        finally:
            c.trace.pop_context()

    @staticmethod
    def register_kernels(manager) -> None:
        manager.register_kernel("grdblas.init", _k_noop)
        manager.register_kernel("grdblas.isamax", _k_isamax)
        manager.register_kernel("grdblas.dot_pre", _k_noop)
        manager.register_kernel("grdblas.dot", _k_dot)
        manager.register_kernel("grdblas.axpby", _k_axpby)
        manager.register_kernel("grdblas.gemm", _k_gemm)


class GrdFFT:
    """cuFFT stand-in (Table 6 ``cufftExecC2C`` row: 2 H2D, alloc, free,
    launch, stream query)."""

    def __init__(self, client: GuardianClient):
        self.client = client

    def exec_c2c(self, x: DevicePtr, out: DevicePtr, n: int) -> None:
        c = self.client
        c.trace.push_context("cufftExecC2C")
        try:
            plan = c.malloc(8)                            # cuMemAlloc
            c.memcpy_h2d(plan, np.zeros(8, np.float32))   # cuMemcpyHtoD x2
            c.memcpy_h2d(plan, np.ones(8, np.float32))
            c.stream_get_capture_info()              # cudaStreamIsCapturing
            c.launch_kernel("grdfft.c2c", ptrs=[x, out], args=(n,))
            c.free(plan)                                  # cuMemFree
        finally:
            c.trace.pop_context()

    @staticmethod
    def register_kernels(manager) -> None:
        manager.register_kernel("grdfft.c2c", _k_fft_c2c)


class GrdSPARSE:
    """cuSPARSE stand-in — the double-indirection SpMV is the adversarial
    showcase: column indices are tenant-controlled device data."""

    def __init__(self, client: GuardianClient):
        self.client = client

    def csr_spmv(self, vals: DevicePtr, cols: DevicePtr, x: DevicePtr,
                 y: DevicePtr, nnz: int, n: int) -> None:
        c = self.client
        c.trace.push_context("cusparseSpMV")
        try:
            c.stream_get_capture_info()
            c.launch_kernel("grdsparse.csr_spmv",
                            ptrs=[vals, cols, x, y], args=(nnz, n))
            c.launch_kernel("grdsparse.csr_spmv_post", ptrs=[y], args=(n,))
        finally:
            c.trace.pop_context()

    @staticmethod
    def register_kernels(manager) -> None:
        manager.register_kernel("grdsparse.csr_spmv", _k_csr_spmv)
        manager.register_kernel("grdsparse.csr_spmv_post", _k_noop)


def register_all_libraries(manager) -> None:
    GrdBLAS.register_kernels(manager)
    GrdFFT.register_kernels(manager)
    GrdSPARSE.register_kernels(manager)
