"""repro_torch — the PyTorch/CUDA port of the Guardian reproduction.

A package beside the JAX reference (``repro``) that imports neither JAX
nor ``repro``.  Its entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``; the hand-written Hopper kernels
of :mod:`repro_torch.kernels` carry the serving path.
"""
