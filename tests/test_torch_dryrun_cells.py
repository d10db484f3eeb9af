"""``run_cell`` on a fake 2x2 world, the second half of the smoke
families' decode cells and qwen2 with ``d_ff=129`` (its MLP splits unevenly
over 'model'), each record held to the reference (part 1 of
``tests/_torch_dryrun_worker.py``, in a process of its own; see
``_torch_dryrun_records`` and ``test_torch_dryrun_world.py``)."""
import pytest

from _torch_dryrun_records import cell_ids, check_record, run_worker

CELLS = cell_ids(1)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    return run_worker(tmp_path_factory.mktemp("dryrun_cells"), 1)


@pytest.mark.parametrize("i", [i for i, _ in CELLS],
                         ids=[n for _, n in CELLS])
def test_run_cell_record(result, i):
    check_record(result, i)
