"""Declared accesses of the hand-written kernels: what address each custom op
``repro_torch::<kernel>`` forms from data, into which operand, under which
fence, and what it does with an id out of range.

The static verifier (:mod:`repro_torch.core.verifier`) cannot look into a
CUDA kernel; it reads this table instead and turns each op node of a traced
step into one access site per entry, whose index interval it computes with
its own transfer functions over what the kernel computes:

    id      = (index & mask) | base                  the Guardian fence
    id      = page_map[id], 0 outside the map        ``page_map`` (K1, K2)
    address = id & (extent - 1)                      ``pool_clamp`` (K1, K2)
    address formed only for id in [-V, V), a         ``out_of_range="nan"``
    negative id wrapped once (NaN row otherwise)     (K3), ``"drop"``
                                                     (K3's backward store)

Each entry states what the CUDA source does (the line it names) and what
the plain version in :mod:`repro_torch.kernels.ref` does; the tests hold the
verdicts of every entry against the verdicts of the plain version traced
into aten under the same fence.  Only the arguments named here may be
addressed from data: every other operand of a kernel is read or written
whole, within its shape.  K4 (flash attention) forms no data-dependent
address, and K5 (the MoE histogram) only one into its own shared-memory
bins, dropping ids outside ``[0, E)``: neither declares an access.

K3's backward (``gather_rows_backward``) is no CUDA kernel: the reference
has none, and the port writes it in PyTorch (``kernels/ref.py``).  It is
declared here all the same, as the store of the table's gradient into the
table's rows at the fenced ids: the optimizer adds that gradient to the
table row for row, so the rows it addresses are rows of the table, and a
traced train step proves them as it proves the gather's load.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ACCESSES", "Access"]


@dataclasses.dataclass(frozen=True)
class Access:
    """One data-dependent address a kernel forms: along dim 0 of the op
    argument ``operand``, from the ids in ``index``.

    ``base`` / ``mask`` name the fence's two forms, ``(tensor argument, int
    argument)``: the tensor (one value per id or row) when it is given,
    else the int by value.  ``page_map`` names the argument translating a
    fenced id (an id outside the map resolves to page 0), ``pool_clamp``
    that the address is ``id & (extent - 1)`` of the power-of-two operand.
    ``out_of_range`` is what the kernel does with an id outside the
    operand: ``"clamp"`` (the pool clamp keeps every id inside),
    ``"nan"`` (no address is formed; the row reads as NaN), ``"drop"`` (no
    address is formed; the store is dropped).  ``store`` is
    whether the access writes; ``duplicates`` how equal addresses of one
    call resolve; ``source`` the line of the CUDA source forming it."""

    operand: str
    index: str
    store: bool
    base: Tuple[str, str]
    mask: Tuple[str, str]
    page_map: Optional[str] = None
    pool_clamp: bool = False
    out_of_range: str = "clamp"
    duplicates: str = ""
    source: str = ""


def _pages(operand: str, index: str, store: bool, source: str,
           base: Tuple[str, str], mask: Tuple[str, str]) -> Access:
    return Access(operand=operand, index=index, store=store, base=base,
                  mask=mask, page_map="page_map", pool_clamp=True,
                  duplicates="last writer wins" if store else "",
                  source=source)


#: op name (in the ``repro_torch`` namespace) -> its declared accesses
ACCESSES: Dict[str, Tuple[Access, ...]] = {
    # K1: csrc/paged_attention.cu:268 — resolve_page(fence_id(id, base,
    # mask), page_map, n_map, P - 1) for the pages of the row's table its
    # share walks (under a window, a suffix: the entry covers them all)
    "paged_attention": tuple(
        _pages(pool, "page_table", False, "paged_attention.cu:268",
               ("base_rows", "base"), ("mask_rows", "mask"))
        for pool in ("k_pages", "v_pages")),
    # K2: csrc/scatter_pages.cu:165 — the same resolution on the store
    # address; of equal destinations only the last id writes (:171)
    "scatter_pages": tuple(
        _pages(pool, "ids", True, "scatter_pages.cu:165",
               ("base_ids", "base"), ("mask_ids", "mask"))
        for pool in ("k_pool", "v_pool")),
    # K3: csrc/gather_rows.cu:46-54 — fence_id, then a negative id in
    # [-V, 0) wraps once and an id outside [0, V) forms no address
    "gather_rows": (Access(
        operand="table", index="idx", store=False,
        base=("base_ids", "base"), mask=("mask_ids", "mask"),
        out_of_range="nan", source="gather_rows.cu:46"),),
    # K3's backward: ref.py's gather_rows_grad_ref fences each id as the
    # load did, wraps a negative one once and drops one past the table
    # onto a spare row of its own accumulator; equal ids sum
    "gather_rows_backward": (Access(
        operand="table", index="idx", store=True,
        base=("base_ids", "base"), mask=("mask_ids", "mask"),
        out_of_range="drop", duplicates="summed in id order",
        source="ref.py:160"),),
    "flash_attention": (),
    "moe_histogram": (),
}
