"""GuardianClient — the ``grdLib`` analogue (Guardian §4.1).

The paper preloads a shim library that shadows the CUDA *runtime + driver*
APIs and forwards every call to the grdManager over IPC.  Here the tenant
holds a ``GuardianClient`` whose methods are the device API surface:

    malloc / free                  (cudaMalloc / cudaFree)
    memcpy_h2d / d2h / d2d         (cudaMemcpy family)
    launch_kernel                  (cudaLaunchKernel)
    synchronize                    (cudaDeviceSynchronize)
    module_load                    (cuModuleLoadData — driver API)

Tenants never see an arena buffer — only opaque :class:`DevicePtr` handles.
Every call is appended to a :class:`CallTrace` with nanosecond timestamps,
which is how we reproduce the paper's Table 5 (interception cost) and
Table 6 (implicit calls from closed-source libraries).

Security note (paper §5 "Bypass Guardian checks"): the client owns no device
state; even a forged ``DevicePtr`` is re-validated by the manager against
the partition bounds table before any transfer, and kernel-borne indices are
fenced inside the sandboxed kernels regardless of what the client claims.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DevicePtr:
    """Opaque device-memory handle: absolute slot address + length.

    Like a raw CUDA pointer this is *forgeable* by a malicious tenant
    (``dataclasses.replace(ptr, addr=...)``) — the manager treats it as
    untrusted input and validates it on every use.

    ``epoch`` stamps which *elastic relocation epoch* of the tenant's
    partition minted the handle: the manager's pointer translation is
    keyed per epoch, so an address reused by a later extent never
    aliases a stale handle's translation (see
    ``GuardianManager._resolve_ptr``).  Forging it only selects a
    different translation table — the result is bounds-validated like
    any address.
    """

    tenant_id: str
    addr: int        # absolute slot index in the flat arena
    length: int      # slots
    epoch: int = 0   # elastic relocation epoch at mint time

    @property
    def end(self) -> int:
        return self.addr + self.length

    @property
    def addr_device(self):
        """Host-staged int32 scalar tensor of .addr, cached (launch fast
        path); the manager moves it to its device at dispatch."""
        try:
            return object.__getattribute__(self, "_addr_dev")
        except AttributeError:
            import torch
            val = torch.tensor(self.addr, dtype=torch.int32)
            object.__setattr__(self, "_addr_dev", val)
            return val

    def addr_on(self, device):
        """:attr:`addr_device` staged on ``device``, cached per device (a
        launch operand of a tenant kernel)."""
        cache = self.__dict__.setdefault("_addr_on", {})
        val = cache.get(device)
        if val is None:
            val = cache[device] = self.addr_device.to(device)
        return val


@dataclasses.dataclass
class CallRecord:
    api: str                 # e.g. "cudaMalloc", "cuLaunchKernel"
    level: str               # "runtime" | "driver"
    tenant_id: str
    detail: str = ""
    t_start_ns: int = 0
    t_end_ns: int = 0
    implicit_of: Optional[str] = None   # high-level library call that caused it

    @property
    def duration_ns(self) -> int:
        return self.t_end_ns - self.t_start_ns


class CallTrace:
    """Per-client call log — Tables 5/6 are computed from this."""

    def __init__(self):
        self.records: List[CallRecord] = []
        self._implicit_ctx: List[str] = []

    def push_context(self, highlevel_call: str) -> None:
        self._implicit_ctx.append(highlevel_call)

    def pop_context(self) -> None:
        self._implicit_ctx.pop()

    def record(self, api: str, level: str, tenant_id: str,
               detail: str = "") -> CallRecord:
        rec = CallRecord(
            api=api, level=level, tenant_id=tenant_id, detail=detail,
            t_start_ns=time.perf_counter_ns(),
            implicit_of=self._implicit_ctx[-1] if self._implicit_ctx else None,
        )
        self.records.append(rec)
        return rec

    def implicit_calls(self) -> Dict[str, Dict[str, int]]:
        """{high-level call: {api: count}} — the paper's Table 6."""
        out: Dict[str, Dict[str, int]] = {}
        for r in self.records:
            if r.implicit_of is None:
                continue
            out.setdefault(r.implicit_of, {})
            out[r.implicit_of][r.api] = out[r.implicit_of].get(r.api, 0) + 1
        return out

    def api_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.api] = out.get(r.api, 0) + 1
        return out


class GuardianClient:
    """The tenant-side device API.  All methods forward to the manager."""

    def __init__(self, manager, tenant_id: str):
        self._manager = manager
        self.tenant_id = tenant_id
        self.trace = CallTrace()

    # ------------------------------------------------------------------ #
    # CUDA-runtime-level surface                                         #
    # ------------------------------------------------------------------ #
    def malloc(self, n_slots: int) -> DevicePtr:
        rec = self.trace.record("cudaMalloc", "runtime", self.tenant_id,
                                f"n={n_slots}")
        ptr = self._manager.malloc(self.tenant_id, n_slots)
        rec.t_end_ns = time.perf_counter_ns()
        return ptr

    def free(self, ptr: DevicePtr) -> None:
        rec = self.trace.record("cudaFree", "runtime", self.tenant_id,
                                f"addr={ptr.addr}")
        self._manager.free(self.tenant_id, ptr)
        rec.t_end_ns = time.perf_counter_ns()

    def memcpy_h2d(self, ptr: DevicePtr, host: np.ndarray) -> None:
        rec = self.trace.record("cudaMemcpyH2D", "runtime", self.tenant_id,
                                f"addr={ptr.addr} n={host.size}")
        self._manager.memcpy_h2d(self.tenant_id, ptr, host)
        rec.t_end_ns = time.perf_counter_ns()

    def memcpy_d2h(self, ptr: DevicePtr, n_slots: Optional[int] = None
                   ) -> np.ndarray:
        rec = self.trace.record("cudaMemcpyD2H", "runtime", self.tenant_id,
                                f"addr={ptr.addr}")
        out = self._manager.memcpy_d2h(self.tenant_id, ptr, n_slots)
        rec.t_end_ns = time.perf_counter_ns()
        return out

    def memcpy_d2d(self, dst: DevicePtr, src: DevicePtr,
                   n_slots: int) -> None:
        rec = self.trace.record("cudaMemcpyD2D", "runtime", self.tenant_id,
                                f"dst={dst.addr} src={src.addr} n={n_slots}")
        self._manager.memcpy_d2d(self.tenant_id, dst, src, n_slots)
        rec.t_end_ns = time.perf_counter_ns()

    def launch_kernel(self, name: str, ptrs: Sequence[DevicePtr] = (),
                      args: Sequence[Any] = (), enqueue: bool = False) -> Any:
        """cudaLaunchKernel: the manager looks up the sandboxed twin in its
        pointerToSymbol map, augments the parameter list with (base, mask)
        and issues it (§4.2.3)."""
        rec = self.trace.record("cudaLaunchKernel", "runtime", self.tenant_id,
                                f"kernel={name}")
        out = self._manager.launch_kernel(self.tenant_id, name, ptrs, args,
                                          enqueue=enqueue)
        rec.t_end_ns = time.perf_counter_ns()
        return out

    def synchronize(self) -> None:
        rec = self.trace.record("cudaDeviceSynchronize", "runtime",
                                self.tenant_id)
        self._manager.synchronize(self.tenant_id)
        rec.t_end_ns = time.perf_counter_ns()

    # ------------------------------------------------------------------ #
    # CUDA-driver-level surface                                          #
    # ------------------------------------------------------------------ #
    def module_load(self, name: str, fn, arena_argnums=(0,),
                    verify: bool = True,
                    fence_aware: bool = False) -> None:
        """cuModuleLoadData: register a kernel.  The manager sandboxes and
        pre-compiles it (paper: 'compiles the sandboxed PTXs at its
        initialization avoiding JIT overhead at runtime').

        ``verify=False`` skips the static bounds verifier: no fences are
        elided and provably out-of-bounds kernels are contained at run
        time instead of refused at trace time."""
        rec = self.trace.record("cuModuleLoadData", "driver", self.tenant_id,
                                f"module={name}")
        self._manager.register_kernel(name, fn, arena_argnums,
                                      verify=verify,
                                      fence_aware=fence_aware)
        rec.t_end_ns = time.perf_counter_ns()

    def event_create(self) -> None:
        rec = self.trace.record("cudaEventCreateWithFlags", "runtime",
                                self.tenant_id)
        rec.t_end_ns = time.perf_counter_ns()

    def event_record(self) -> None:
        rec = self.trace.record("cudaEventRecord", "runtime", self.tenant_id)
        rec.t_end_ns = time.perf_counter_ns()

    def stream_get_capture_info(self) -> None:
        rec = self.trace.record("cudaStreamGetCaptureInfo", "runtime",
                                self.tenant_id)
        rec.t_end_ns = time.perf_counter_ns()

    # cudaGetExportTable analogue: undocumented entry points that big
    # frameworks hit; we expose a minimal table (paper §4.1 second challenge).
    def get_export_table(self, table_id: int) -> Dict[str, Any]:
        rec = self.trace.record("cudaGetExportTable", "runtime",
                                self.tenant_id, f"table={table_id}")
        rec.t_end_ns = time.perf_counter_ns()
        return self._manager.export_table(table_id)
