"""Shared helpers of the tenant-kernel parity tests
(``tests/test_torch_sandbox.py``, ``test_torch_verifier.py``,
``test_torch_tenant.py``).

A scenario is written once against a small framework adapter and run on
both sides: ``JAX`` drives the reference (``repro.core``), ``TORCH`` the
port (``repro_torch.core``, on the CPU).  Each tenant kernel exists twice,
once in jnp and once in torch, with the same access pattern; the
adapters hand out the right one by name.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core as RJ
import repro_torch.core as RT
from _torch_parity import np_of


# -- the kernels, in jnp and in torch --------------------------------------

def bump_j(arena, ptr, n):
    idx = ptr + jnp.arange(n, dtype=jnp.int32)
    vals = jnp.take(arena, idx, axis=0)
    return arena.at[idx].set(vals + 1.0), None


def bump_t(arena, ptr, n):
    idx = ptr + torch.arange(n, dtype=torch.int32, device=arena.device)
    arena[idx] = torch.take(arena, idx.long()) + 1.0
    return arena, None


def evil_j(arena, target, n):
    idx = target + jnp.arange(n, dtype=jnp.int32)
    return arena.at[idx].set(999.0), None


def evil_t(arena, target, n):
    idx = target + torch.arange(n, dtype=torch.int32, device=arena.device)
    arena[idx] = 999.0
    return arena, None


def echo_j(arena, ptr, n):
    idx = ptr + jnp.arange(n, dtype=jnp.int32)
    vals = jnp.take(arena, idx, axis=0)
    return arena.at[idx].set(vals + 1.0), jnp.sum(vals)


def echo_t(arena, ptr, n):
    idx = ptr + torch.arange(n, dtype=torch.int32, device=arena.device)
    vals = torch.take(arena, idx.long())
    arena[idx] = vals + 1.0
    return arena, vals.sum()


def oob_j(arena, n):
    idx = 9999 + jnp.arange(n, dtype=jnp.int32)
    return arena.at[idx].set(1.0), None


def oob_t(arena, n):
    idx = 9999 + torch.arange(n, dtype=torch.int32, device=arena.device)
    arena[idx] = 1.0
    return arena, None


def oob200_j(arena, n):
    idx = 200 + jnp.arange(n, dtype=jnp.int32)
    return arena.at[idx].set(1.0), None


def oob200_t(arena, n):
    idx = 200 + torch.arange(n, dtype=torch.int32, device=arena.device)
    arena[idx] = 1.0
    return arena, None


def noop_j(arena, n):
    return arena, None


def noop_t(arena, n):
    return arena, None


def fence_aware_j(arena, base, mask, ptr):
    idx = ptr + jnp.arange(8, dtype=jnp.int32)
    return arena, jnp.take(arena, (idx & mask) | base, axis=0)


def fence_aware_t(arena, base, mask, ptr):
    idx = ptr + torch.arange(8, dtype=torch.int32, device=arena.device)
    return arena, torch.take(arena, ((idx & mask) | base).long())


def raw_pointer_j(arena, ptr):
    return arena, jnp.take(arena, ptr + jnp.arange(4, dtype=jnp.int32),
                           axis=0)


def raw_pointer_t(arena, ptr):
    idx = ptr + torch.arange(4, dtype=torch.int32, device=arena.device)
    return arena, torch.take(arena, idx.long())


def static_oob_j(arena, x):
    idx = jnp.arange(4, dtype=jnp.int32) - 10_000_000
    return arena, jnp.take(arena, idx, axis=0) + x


def static_oob_t(arena, x):
    idx = torch.arange(4, dtype=torch.int32, device=arena.device) \
        - 10_000_000
    return arena, torch.take(arena, idx.long()) + x


def clamped_j(arena, ptr):
    idx = jnp.clip(ptr, 64, 120) + jnp.arange(4, dtype=jnp.int32)
    return arena, jnp.take(arena, idx, axis=0)


def clamped_t(arena, ptr):
    idx = torch.clamp(ptr, 64, 120) + torch.arange(
        4, dtype=torch.int32, device=arena.device)
    return arena, torch.take(arena, idx.long())


KERNELS = {
    name: (globals()[name + "_j"], globals()[name + "_t"])
    for name in ("bump", "evil", "echo", "oob", "oob200", "noop",
                 "fence_aware", "raw_pointer", "static_oob", "clamped")
}


# -- framework adapters -----------------------------------------------------

class _FW:
    name: str
    core: object

    def kernel(self, name):
        return KERNELS[name][self.index]

    def manager(self, **kw):
        raise NotImplementedError

    def arena(self, mgr) -> np.ndarray:
        return np_of(mgr.arena.buf).copy()

    def read(self, mgr, base, size) -> np.ndarray:
        return np_of(mgr.arena.unsafe_read_range(base, size)).copy()


class _JaxFW(_FW):
    name, core, index = "jax", RJ, 0

    def manager(self, **kw):
        return RJ.GuardianManager(**kw)

    def i32(self, v):
        return jnp.int32(v)

    def f32(self, v):
        return jnp.float32(v)


class _TorchFW(_FW):
    name, core, index = "torch", RT, 1

    def manager(self, **kw):
        kw.pop("jit_trusted", None)
        return RT.GuardianManager(device="cpu", **kw)

    def i32(self, v):
        return torch.tensor(v, dtype=torch.int32)

    def f32(self, v):
        return torch.tensor(v, dtype=torch.float32)


JAX, TORCH = _JaxFW(), _TorchFW()


def on_both(scenario):
    """Run ``scenario(fw)`` on the reference and on the port; returns the
    two results."""
    return scenario(JAX), scenario(TORCH)


def assert_same_tree(a, b, path="") -> None:
    """Equal nested results: arrays bit for bit, everything else by
    ``==``."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, (np.ndarray, jax.Array, torch.Tensor)) or \
            isinstance(b, (np.ndarray, jax.Array, torch.Tensor)):
        np.testing.assert_array_equal(np_of(a), np_of(b), err_msg=path)
    else:
        assert a == b, (path, a, b)
