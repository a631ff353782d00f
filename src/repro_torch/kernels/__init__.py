"""Hand-written Hopper kernels of the port, one module per kernel.

Each module holds its wrapper (plain PyTorch version for CPU tensors, the
CUDA kernel for CUDA tensors) and a launch counter (``KERNEL``); the CUDA
sources live in ``csrc/`` and are built by ``_build.py`` on first use.

    paged_attention   K1  fenced paged decode attention
    scatter_pages     K2  fenced prefill KV page write
    gather_rows       K3  fenced embedding-row gather
    flash_attention   K4  blocked causal prefill attention
"""

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gather_rows import gather_rows
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.scatter_pages import scatter_pages

__all__ = ["flash_attention", "gather_rows", "paged_attention",
           "scatter_pages"]
