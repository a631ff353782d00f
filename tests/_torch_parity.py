"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
numpy bridges between the JAX reference and the PyTorch port, and the
tolerances the tests hold the port to.

Inputs are made with numpy from a seed and handed to both frameworks; the
port runs on the CPU (``device="cpu"``), where every kernel wrapper takes
its plain PyTorch version.
"""

import numpy as np
import torch

# The suite runs several test processes side by side; the port's CPU
# tensors here are tiny, so intra-op threads only oversubscribe the cores
# the JAX reference tests share.
torch.set_num_threads(1)

#: float32 / bfloat16 tolerances of the kernel sweeps (as in
#: tests/test_kernels.py) and of the model path (float32, reduced configs)
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
TOL_MODEL = 1e-4

def np_of(x) -> np.ndarray:
    """numpy view of a JAX array or a torch tensor (bf16 -> float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def t_of(arr, dtype=None) -> torch.Tensor:
    """CPU torch tensor of a numpy array (or JAX array), optionally cast."""
    t = torch.from_numpy(np.array(np_of(arr)))
    return t if dtype is None else t.to(dtype)


def params_np(params):
    """A JAX params pytree as nested dicts of numpy arrays."""
    import jax
    return jax.tree.map(np.asarray, params)


def assert_close(a, b, tol) -> None:
    np.testing.assert_allclose(np_of(a).astype(np.float32),
                               np_of(b).astype(np.float32),
                               atol=tol, rtol=tol)


def assert_same(a, b) -> None:
    np.testing.assert_array_equal(np_of(a), np_of(b))
