"""The port's per-device counter (``repro_torch.utils.hlo_analysis.
analyze``) against the reference's HLO analyzer on the same smoke
programs: the serve step on a cache of 64 (batch 2) for all 10 families
(``forward_prefill`` is in ``test_torch_dryrun_counter.py``).  Dot FLOPs
must be exactly equal (F10 does not reach decode: the hybrid decode runs
its shared block only where the reference's does); no relative
tolerance.
The train steps are in ``test_torch_dryrun_train.py``."""
import pytest

from _torch_dryrun_harness import (compile_references, named_gap,
                                   port_stats, reference_dot_flops)
from repro import configs as jconfigs

CASES = [(a, "decode") for a in jconfigs.ARCHS]


@pytest.fixture(scope="module", autouse=True)
def references():
    pool = compile_references(CASES)
    yield
    pool.shutdown(wait=True)


@pytest.mark.parametrize("arch,kind", CASES,
                         ids=[f"{a}-{k}" for a, k in CASES])
def test_dot_flops_match_the_reference_hlo(arch, kind):
    got = port_stats(arch, kind)
    want = reference_dot_flops(arch, kind)
    assert got.dot_flops > 0
    assert want - got.dot_flops == named_gap(arch, kind), (want,
                                                           got.dot_flops)
    assert got.trip_counts == {} and got.unresolved_loops == []
    assert got.collective_bytes == {} and got.n_collectives == 0
