"""The port stands alone: no module of ``repro_torch`` imports JAX or the
JAX package (``repro``), its configs equal the reference's, and its entry
points default to the card — on a machine without CUDA they raise rather
than run on the CPU."""

import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs import get_config as get_config_t, \
    list_archs as list_archs_t  # noqa: E402

PKG = Path(repro_torch.__file__).resolve().parent
MODULES = sorted(PKG.rglob("*.py"))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(PKG)) for p in MODULES])
def test_module_imports_neither_jax_nor_reference(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(PKG)} imports {sorted(bad)}"


def test_chip_smoke_imports_neither_jax_nor_reference():
    path = PKG.parents[1] / "chip_smoke.py"
    assert not {"jax", "jaxlib", "repro"} & set(_imported_roots(path))


def test_configs_equal_reference():
    assert list_archs_t() == list_archs()
    for name in list_archs():
        assert dataclasses.asdict(get_config_t(name)) == \
            dataclasses.asdict(get_config(name)), name
        assert dataclasses.asdict(get_config_t(name).reduced()) == \
            dataclasses.asdict(get_config(name).reduced()), name


def test_default_device_entry_points_raise_without_cuda():
    """Entry points default to ``device="cuda"``; without a card they
    refuse instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")
    from repro_torch.core.manager import GuardianManager
    from repro_torch.launch.serve import ServeEngine, make_shared_manager
    from repro_torch.models import get_model
    from repro_torch.models import kvcache as KV

    cfg = get_config_t("stablelm-3b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_shared_manager(1, max_batch=2, max_len=64, paged=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        GuardianManager(total_slots=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, max_batch=2, max_len=64, paged=True)
    with pytest.raises((RuntimeError, AssertionError)):
        get_model(cfg).init(torch.Generator())
    with pytest.raises((RuntimeError, AssertionError)):
        KV.init_global_kv_cache(cfg, 2, 64, 4)


@pytest.mark.parametrize("module", ["repro_torch.lint",
                                    "repro_torch.kernels.access"])
def test_lint_and_declared_accesses_import_alone(module):
    """The lint CLI and the kernels' declared-access table are modules of
    the package (so the ast check above covers them) and import in a fresh
    interpreter without loading JAX or the reference."""
    import os
    import subprocess
    import sys

    assert PKG.joinpath(*module.split(".")[1:]).with_suffix(".py") in MODULES
    code = (f"import sys; import {module}; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    src = str(PKG.parent)
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": src})
