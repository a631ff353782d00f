"""Hand-written Hopper kernels of the port, one module per kernel.

Each module holds its wrapper, the custom op ``repro_torch::<kernel>`` it
calls (the plain PyTorch version for CPU tensors, the CUDA kernel for CUDA
tensors, shapes only for a trace's fake tensors) and a launch counter
(``KERNEL``); the CUDA sources live in ``csrc/`` and are built by
``_build.py`` on first use.  ``access.py`` declares what each kernel
addresses, for the static verifier.  Each module also declares its op's
DTensor sharding rule (``_build.sharding_rule``), registered only when a
mesh opens a process group (:func:`register_sharding_rules`): a custom
op with no rule raises with its name under DTensor, never replicated
in silence.  K2 has none: the step bundles keep the slab layout, whose
prefill write is no K2 call.

    paged_attention   K1  fenced paged decode attention
    scatter_pages     K2  fenced prefill KV page write
    gather_rows       K3  fenced embedding-row gather
    flash_attention   K4  blocked causal prefill attention
    moe_histogram     K5  fenced MoE expert histogram
"""

from repro_torch.kernels._build import SHARDING_RULES
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gather_rows import gather_rows
from repro_torch.kernels.moe_histogram import moe_histogram
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.scatter_pages import scatter_pages

_registered: list = []


def register_sharding_rules() -> None:
    """Register every kernel's sharding rule with DTensor, once."""
    if _registered:
        return
    from torch.distributed.tensor.experimental import register_sharding
    for op, rule in SHARDING_RULES:
        register_sharding(op)(rule)
    _registered.append(True)


__all__ = ["flash_attention", "gather_rows", "moe_histogram",
           "paged_attention", "register_sharding_rules", "scatter_pages"]
