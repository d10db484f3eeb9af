"""Per-device work accounting for the roofline (the port of
``repro.utils.hlo_analysis``).

The reference parses XLA's compiled, partitioned HLO text.  Torch compiles
no HLO, so the port counts the same quantities while the program runs:
``analyze(fn, *args)`` calls ``fn`` under a dispatch mode that sees every
ATen operation one device issues, on real tensors or on fake ones (the
dry-run), and yields

  * ``dot_flops``        — the matrix products' FLOPs (``mm``, ``bmm``,
                           ``addmm``, ``baddbmm``, convolutions and fused
                           attention, by the formulas that
                           ``torch.utils.flop_counter`` registers: 2*M*N*K
                           for a product), at the shapes one device holds;
  * ``hbm_bytes``        — every operation that launches work reads its
                           tensor inputs once and writes its outputs once:
                           eager torch fuses nothing, so each operation is a
                           boundary of the reference's fusion model.  Views,
                           metadata operations, allocations, ``wait_tensor``
                           and the collectives move no bytes here;
  * ``collective_bytes`` — result bytes of each collective under the
                           reference's kind names (``all-gather``,
                           ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
                           ``collective-permute``: a point-to-point receive),
                           and ``n_collectives``;
  * argument, output and peak temporary bytes (``argument_bytes``,
    ``output_bytes``, ``temp_bytes``): the storages of ``fn``'s tensor
    arguments and of its result, and the most bytes of storage the run
    itself had allocated and alive at once (its outputs included while they
    live).

A Python loop dispatches each of its iterations, so there are no trip
counts to recover: ``trip_counts`` is ``{}`` and ``unresolved_loops`` is
``[]``.  A branch not taken dispatches nothing, so it is not counted (the
reference's analyzer weighs both branches of a conditional).

Over ``DTensor`` arguments the mode defers to DTensor, which lowers each
operation to the operations on this rank's local shards (and the
collectives its redistributions need); those come back through the mode at
local shapes.  DTensor's sharding propagation runs some operations on fake
tensors of the global shapes under a fake mode of its own; they are not
counted.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.compat import DTensor

__all__ = ["analyze", "HloStats"]


@dataclasses.dataclass
class HloStats:
    collective_bytes: dict
    dot_flops: float
    hbm_bytes: float
    trip_counts: dict
    n_collectives: int
    unresolved_loops: list
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))


_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "irecv": "collective-permute",
    "batch_p2p_ops": "collective-permute",
    "recv_": "collective-permute",
}
# Collective namespaces: the functional collectives (DTensor's and
# ``compat.all_to_all_single``'s) and the process group's own operations.
_COMM_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
# Operations that launch no work: allocations, and the wait on a collective.
_NO_WORK = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "wait_tensor", "lift_fresh", "detach",
            "_local_scalar_dense", "alias", "set_", "resize_"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storages(tensors) -> list:
    """The distinct storages of ``tensors`` (a DTensor's: its local
    shard's)."""
    out, seen = [], set()
    for t in tensors:
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            out.append(st)
    return out


class _Counter(TorchDispatchMode):
    def __init__(self, arguments):
        super().__init__()
        self.coll = defaultdict(float)
        self.n_coll = 0
        self.flops = 0.0
        self.hbm = 0.0
        self._known = WeakIdKeyDictionary()   # storage -> counted as live
        for st in arguments:
            self._known[st] = False
        self.live = 0
        self.peak = 0
        self._entry_fake = None

    def __enter__(self):
        self._entry_fake = active_fake_mode()
        return super().__enter__()

    def _track(self, st) -> None:
        if st in self._known:
            return
        n = st.nbytes()
        self._known[st] = True
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._entry_fake:
            return out          # DTensor's sharding propagation
        ns = func.namespace
        name = func.__name__.split(".")[0]
        outs = _tensors(out)
        if ns in _COMM_NS:
            kind = _KIND.get(name)
            if kind is not None:
                got = args[0] if name == "recv_" else out
                self.coll[kind] += sum(_nbytes(t) for t in _tensors(got))
                self.n_coll += 1
        elif name not in _NO_WORK and not func.is_view and outs:
            packet = func.overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            self.hbm += sum(_nbytes(t) for t in _tensors((args, kwargs))
                            + outs)
        if name != "wait_tensor":   # a fake wait returns a fresh tensor
            for t in outs:
                self._track(t.untyped_storage())
        return out


def analyze(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` run once under the counter: returns
    ``(result, HloStats)`` of one device's work (see the module
    docstring)."""
    arguments = _storages(_tensors((args, kwargs)))
    counter = _Counter(arguments)
    with counter:
        result = fn(*args, **kwargs)
    outputs = _storages(_tensors(result))
    stats = HloStats(
        collective_bytes=dict(counter.coll),
        dot_flops=float(counter.flops),
        hbm_bytes=float(counter.hbm),
        trip_counts={},
        n_collectives=counter.n_coll,
        unresolved_loops=[],
        argument_bytes=sum(st.nbytes() for st in arguments),
        output_bytes=sum(st.nbytes() for st in outputs),
        temp_bytes=counter.peak,
    )
    return result, stats
