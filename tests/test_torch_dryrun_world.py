"""The port's dry-run on fake worlds, held to the reference (part 0 of
``tests/_torch_dryrun_worker.py``, a jax-free process of its own, so no
process group of another test meets the fake world and none outlives it;
part 1 is ``test_torch_dryrun_cells.py``).

* ``make_production_mesh``: the reference's shapes, axis names and sizes,
  ``(16, 16)`` over ``("data", "model")`` and ``(2, 16, 16)`` over
  ``("pod", "data", "model")``, each inside ``fake_world(256 / 512)``,
  never outside one; inside, a second ``fake_world`` and
  ``make_local_mesh`` raise; after each world no default group is up.
* The reference's canned HLO programs (``tests/test_sharding_and_hlo.py``),
  written as torch programs on a fake world of 4 and counted by
  ``analyze``: a 12-iteration loop of an 8x8 all-reduce and product gives
  all-reduce 8*8*4*12 bytes and 2*64*8*12 FLOPs; all-to-all 16*8*4,
  reduce-scatter 4*8*4, collective-permute (a receive) 4*8*4 and
  all-gather 16*8*4, four collectives.  The all-gather differs from the
  reference's canned number on purpose: the reference counts the tuple of
  its ``all-gather-start``, which also holds the aliased input
  ((4*8 + 16*8)*4); torch's all-gather has only its result.
* ``run_cell`` on a fake 2x2 world, the first half of the smoke families'
  decode cells (batch 8, cache 64): see ``_torch_dryrun_records``.
"""
import math

import pytest

from _torch_dryrun_records import cell_ids, check_record, run_worker

CELLS = cell_ids(0)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    return run_worker(tmp_path_factory.mktemp("dryrun_world"), 0)


def test_production_meshes(result):
    m = result["meshes"]
    assert not m["up_before"]
    assert "fake_world(256)" in m["outside"]
    for n, shape, names in ((256, [16, 16], ["data", "model"]),
                            (512, [2, 16, 16], ["pod", "data", "model"])):
        got = m[str(n)]
        assert got["shape"] == shape and got["names"] == names
        assert got["size"] == got["world"] == n == math.prod(shape)
        assert got["backend"] == "fake"
        assert "already up" in got["nested"]
        assert "fake world" in got["local"]
        assert m[f"up_after_{n}"] is False


def test_canned_loop_counts(result):
    s = result["loop"]
    assert s["collective_bytes"] == {"all-reduce": 8 * 8 * 4 * 12}
    assert s["dot_flops"] == 2 * 64 * 8 * 12
    assert s["n_collectives"] == 12
    assert s["trip_counts"] == {} and s["unresolved_loops"] == []


def test_canned_collective_kinds(result):
    s = result["kinds"]
    assert s["collective_bytes"] == {
        "all-to-all": 16 * 8 * 4, "reduce-scatter": 4 * 8 * 4,
        "collective-permute": 4 * 8 * 4, "all-gather": 16 * 8 * 4}
    assert s["n_collectives"] == 4


@pytest.mark.parametrize("i", [i for i, _ in CELLS],
                         ids=[n for _, n in CELLS])
def test_run_cell_record(result, i):
    check_record(result, i)
