"""The partitioned step bundles with real collectives: every family x
train / prefill / decode bundle (``test_torch_dryrun_mesh._bundle``'s
shapes, the serve pools in float32) partitioned by DTensor
(``StepBundle.partitioned``'s program) and run as every rank of a gloo
group of CPU processes on a (data=2, model=4) and a (2, 2) mesh
(``Mesh.join`` over a ``FileStore``: the loopback device, no network),
each rank on its shards of seeded inputs, each result leaf against the
same shard of the unpartitioned ``bundle.step`` on the same inputs:

* serve bundles: the cache and the logits; train bundles: the loss, the
  parameters and both AdamW moments (carried in non-zero, so that a
  gradient's error shows in the first moment);
* every float leaf within 1e-5 of its largest entry, ids, page tables,
  lengths and step counts equal;
* one block: K3 over a vocab-split table, its ids split over the data
  axis, the table's gradient against the unpartitioned one.

Both meshes' ranks (12 processes, ``tests/_partition_run.py``) are
spawned once for the module and run beside each other; each case reads
its (mesh, family, kind) result.  A rank that cannot start or times out
fails its cases with its own traceback.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import _partition_run as PR  # noqa: E402

MESHES = ((2, 4), (2, 2))
CASES = [(f, k) for f in sorted(PR.FAMILIES) for k in PR.KINDS]
EMBED = ("embed_grad",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mesh, per case: the ranks' merged results."""
    root = tmp_path_factory.mktemp("partition_run")
    handles = {}
    for data, model in MESHES:
        cases = ([EMBED] if (data, model) == (2, 4) else []) + CASES
        handles[data, model] = PR.start(
            data, model, cases, os.path.join(root, f"{data}x{model}"))
    return {mesh: PR.finish(h) for mesh, h in handles.items()}


def _held(result):
    if "error" in result:
        pytest.fail(result["error"], pytrace=False)
    leaves = result["leaves"]
    bad = {k: v for k, v in leaves.items()
           if (v != 0 if isinstance(v, int) else v > PR.TOL)}
    assert not bad, bad
    return leaves


@pytest.mark.parametrize("family,kind", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_partitioned_bundle_matches_unpartitioned(runs, mesh, family, kind):
    leaves = _held(runs[mesh]["/".join((family, kind))])
    tops = {k.split("/")[0] for k in leaves}
    if kind == "train":
        # params, both moments and the step count, the loss
        assert {"0", "2"} <= tops and "2/loss" in leaves
        assert any(k.startswith("1/m/") for k in leaves)
        assert any(k.startswith("1/v/") for k in leaves)
        assert "1/step" in leaves
    else:
        assert tops == {"0", "1"}           # the cache, the logits


def test_embedding_gradient_over_split_data_axis(runs):
    """K3 over a table split by vocab row on the model axis, the ids
    split over the data axis: each rank's table gradient sums every data
    rank's rows (a partial sum over data), as the unpartitioned one."""
    leaves = _held(runs[2, 4]["embed_grad"])
    assert set(leaves) == {"table"}
