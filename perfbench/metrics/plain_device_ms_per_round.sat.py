"""Device ms per pool round in kernels that are none of the port's K1-K7:
the plain-torch threefry draw for the write errors, the DVFS pick and the
eager selects, from the traced stretch."""
from perfbench.metrics import _read

OURS = ("stcf_score_kernel", "fused_tile_kernel", "harris_kernel",
        "ring_push_kernel", "compact_kernel", "nmc_tile_kernel",
        "tos_count_kernel")
COPIES = ("Memcpy", "Memset", "memcpy", "memset")


def read(rec):
    p = _read.profile(rec)
    if p is None:
        return None
    s = sum(v[1] for k, v in p["by_name"].items()
            if not any(n in k for n in OURS + COPIES))
    return s / p["rounds"] * 1e3
