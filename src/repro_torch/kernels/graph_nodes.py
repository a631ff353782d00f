"""CUDA-graph conditional nodes (``csrc/graph_nodes.cu``): the device
side of a tenant kernel's ``torch.cond`` and ``while_loop`` inside a
captured graph.

A graph helper, not a port of a TPU kernel: it addresses no arena, has no
launch counter and adds no row to the kernel table.  While a graph is
captured on the current stream, :func:`conditional` adds an ``if`` or a
``while`` node whose condition a one-thread kernel sets from a device
predicate, and captures the body the ``with`` block issues into the
node's body graph, with its allocations taken from the capturing
graph's memory pool (:func:`_route_thread_to`).  A body is captured on a
stream this module creates, one per device and nesting depth
(:func:`_body_stream`): never torch's stream pool, whose streams come
round again after 32 draws, so a body's stream is never the capturing
stream nor an enclosing body's.  A ``while`` body ends with
:func:`set_condition` on its next predicate.  Nothing reads a predicate
on the host, so a data-dependent trip count or branch replays inside the
one graph with no sync.

Built like the kernels (``_build.build_all``) at first use; imports on
machines without ``nvcc`` or a GPU, where it is never called.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Any, Dict, Iterator, List

import torch

from repro_torch.kernels import _build

SOURCE = "graph_nodes.cu"
IF, WHILE = 0, 1

_P, _I, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
_SIGS = {
    "graph_nodes_begin": [_P, _P, _I, _I, ctypes.POINTER(_P),
                          ctypes.POINTER(_U64)],
    "graph_nodes_set": [_P, _U64, _P, _I],
    "graph_nodes_capture_to": [_P, _P],
    "graph_nodes_end_capture": [_P, _P],
    "graph_nodes_stream_new": [ctypes.POINTER(_P)],
}
_lib = None
#: per device index, the body streams by nesting depth (created once,
#: kept for the process) and how many bodies are being captured
_streams: Dict[int, List[torch.cuda.ExternalStream]] = {}
_depth: Dict[int, int] = {}


def _fns():
    global _lib
    if _lib is None:
        path = _build._lib_path(SOURCE)
        if not path.exists():
            _build.build_all([SOURCE])
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGS.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        lib.graph_nodes_error_string.argtypes = [ctypes.c_int]
        lib.graph_nodes_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _fns().graph_nodes_error_string(rc).decode()
        raise RuntimeError(f"conditional node: {what} failed ({rc}: {msg})")


def _pred(pred: torch.Tensor) -> torch.Tensor:
    if pred.device.type != "cuda" or pred.numel() != 1:
        raise ValueError("a conditional node's predicate is one element on "
                         "the card")
    return pred.reshape(()).to(torch.bool)


def set_condition(handle: int, pred: torch.Tensor) -> None:
    """Set ``handle``'s condition from ``pred`` (one element on the card)
    on the current stream: a one-thread kernel, captured where it is
    issued (the end of a ``while`` body)."""
    p = _pred(pred)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    _check(_fns().graph_nodes_set(_P(stream), _U64(handle),
                                  _build.ptr(p), 0), "set the condition")


@contextlib.contextmanager
def conditional(pred: torch.Tensor, kind: int, pool: Any,
                negate: bool = False) -> Iterator[int]:
    """Add an ``if`` (``kind=IF``) or ``while`` (``kind=WHILE``) node to
    the graph being captured on the current stream, first evaluated from
    ``pred`` (negated with ``negate``), and capture the block's operations
    into its body; yields the node's handle.  ``pool`` is the capturing
    graph's memory pool: the body's temporaries are allocated from it, so
    they live as long as the graph."""
    p = _pred(pred)
    index = _index(p.device)
    stream = torch.cuda.current_stream(p.device)
    body, handle = _P(), _U64()
    _check(_fns().graph_nodes_begin(_P(stream.cuda_stream), _build.ptr(p),
                                    kind, int(negate), ctypes.byref(body),
                                    ctypes.byref(handle)),
           "add the node")
    depth = _depth.get(index, 0)
    child = _body_stream(index, depth)
    _check(_fns().graph_nodes_capture_to(_P(child.cuda_stream), body),
           "begin the body's capture")
    _route_thread_to(index, pool)
    _depth[index] = depth + 1
    try:
        with torch.cuda.stream(child):
            yield int(handle.value)
    finally:
        _depth[index] = depth
        _check(_fns().graph_nodes_end_capture(_P(child.cuda_stream), body),
               "end the body's capture")


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else \
        torch.cuda.current_device()


def _body_stream(index: int, depth: int) -> torch.cuda.ExternalStream:
    """The stream a body at nesting ``depth`` on device ``index`` is
    captured on: created on first use and kept, one per depth, so the
    bodies being captured at one time each have their own."""
    streams = _streams.setdefault(index, [])
    while len(streams) <= depth:
        raw = _P()
        with torch.cuda.device(index):
            _check(_fns().graph_nodes_stream_new(ctypes.byref(raw)),
                   "create a body stream")
        streams.append(torch.cuda.ExternalStream(raw.value, device=index))
    return streams[depth]


def _route_thread_to(index: int, pool: Any) -> None:
    """Route every allocation of this thread to ``pool`` until the graph's
    capture ends.  The capture routes only its own stream's allocations
    there, and a body is captured on another stream; the allocator keeps
    one route per pool, so the capture's route gives way to this one,
    which its ``capture_end`` then removes.  The route's reference to the
    pool is given back at once: the graph holds its own."""
    torch._C._cuda_endAllocateToPool(index, pool)
    torch._C._cuda_beginAllocateCurrentThreadToPool(index, pool)
    torch._C._cuda_releasePool(index, pool)
