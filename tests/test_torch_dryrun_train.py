"""The port's per-device counter against the reference's HLO analyzer on
a smoke train step (batch 2 x 64 tokens, float32 AdamW state, remat
``dots``) for qwen2_0_5b, olmoe_1b_7b and zamba2_1_2b: dot FLOPs exactly
equal, or apart by exactly the products ``_torch_dryrun_harness.
named_gap`` names (zamba2: F10's untaken shared-block branches, forward,
recompute and backward, and the SSD backward's multiply-reduce products
that XLA turns into dots)."""
import pytest

from _torch_dryrun_harness import (compile_references, named_gap,
                                   port_stats, reference_dot_flops)

ARCHS = ["qwen2_0_5b", "olmoe_1b_7b", "zamba2_1_2b"]


@pytest.fixture(scope="module", autouse=True)
def references():
    pool = compile_references([(a, "train") for a in ARCHS])
    yield
    pool.shutdown(wait=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_dot_flops_match_the_reference_hlo(arch):
    got = port_stats(arch, "train")
    want = reference_dot_flops(arch, "train")
    assert got.dot_flops > 0
    assert want - got.dot_flops == named_gap(arch, "train"), (
        want, got.dot_flops)
    # the step's state is its arguments; new params and state come out
    assert got.output_bytes > got.argument_bytes // 2 > 0
