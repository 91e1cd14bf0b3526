"""Per-device cost of one traced run of a program: the port's counterpart of
``repro/launch/hlo_analysis.py``.

JAX's dry run compiles each cell's per-device SPMD program and parses its
optimized HLO: dot and convolution FLOPs, the operand and output bytes of
every memory-touching op, the output bytes of every collective, each while
body's count multiplied by its trip count.  The port has no HLO: it runs
the per-device program eagerly, op by op.  So its counterpart is a
``TorchDispatchMode`` (:class:`CostMode`) around one run of rank 0's
program: on meta tensors over a fake process group in the dry run
(``launch/dryrun.py``), or on the card around a real step.  Per device it
counts:

* ``flops``: the matmul, convolution and attention FLOPs of every op, by
  the formulas of ``torch.utils.flop_counter``'s registry (an op with no
  formula is decomposed first, as ``FlopCounterMode`` does).  The
  hand-written kernels of the path are operators of their own
  (``torch.ops.repro_torch``, ``kernels/ops.py``) with a formula there:
  the mode sees each call as one op on every device (a ctypes launch, the
  plain version on the CPU, the contract on meta), so the count is the
  same on the CPU, on the card and on meta.  ``kernel_calls`` counts them.
* ``hbm_bytes``: the inputs plus the outputs of every op that is not a view
  or a bare allocation (``hlo_analysis.py``'s convention; for a kernel,
  what its cost function counts), and each collective's output.  The port
  runs eagerly and unfused, so this is its traffic, not an upper bound of
  it.
* ``collective_bytes``: each collective's output bytes by type
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``), and
  by the mesh axis of its group (``collective_bytes_by_axis``).  Every
  collective of the port (``distributed/sharding.py``'s gathers, f and g
  and reductions, ``distributed/collectives.py``'s int8 reduction, the MoE
  alltoall) is a c10d op, which the mode sees in this one place.
* ``peak_bytes``: the most bytes alive at once.  Each storage counts once,
  from the op that made it to the death of its last tensor (autograd's
  saved tensors and a checkpoint's recompute included); the arguments,
  made before the run, count throughout.  A kernel's own scratch (the
  partial sums of a split), made and freed inside its one op, is not seen.

No loop multiplier is needed (``hlo_analysis.py`` multiplies while bodies
by ``known_trip_count``): the trace runs every layer, so it is 1.
"""
from __future__ import annotations

import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.ops import NAMESPACE as KERNEL_NAMESPACE

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
# c10d ops -> collective type; each one's output tensors are its first argument
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}
_ATEN = torch.ops.aten
# ops that move no bytes of their own: bare allocations and aliasing
_NO_TRAFFIC = {
    _ATEN.empty.memory_format, _ATEN.empty_strided.default, _ATEN.empty_like.default,
    _ATEN.new_empty.default, _ATEN.new_empty_strided.default, _ATEN.detach.default,
    _ATEN._unsafe_view.default, _ATEN.lift_fresh.default, _ATEN.alias.default,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def group_axes(mesh) -> dict[str, str]:
    """{process-group name: mesh axis} of each named axis of ``mesh`` (a
    ``DeviceMesh``)."""
    if mesh is None:
        return {}
    return {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}


class CostMode(TorchDispatchMode):
    """Counts the cost of everything run under it (see the module note).

    ``arguments``: the tensors made before the run that it reads (the
    params, optimizer state, batch and cache), alive throughout; ``mesh``
    names the groups of the collectives by its axes."""

    def __init__(self, arguments=(), mesh=None):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.collective_bytes = Counter({c: 0 for c in COLLECTIVES})
        self.collective_bytes_by_axis: dict[str, Counter] = {}
        self.kernel_calls: Counter = Counter()
        self.ops = 0
        self.live = self.peak = 0
        self._alive: dict[int, weakref.ref] = {}
        self._axes = group_axes(mesh)
        for t in _tensors(arguments):
            self._track(t)
        self.argument_bytes = self.live

    # ------------------------------------------------------------ memory
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._alive:
            return
        n = st.nbytes()

        def free(ref, key=key, n=n):
            if self._alive.get(key) is ref:
                del self._alive[key]
                self.live -= n

        self._alive[key] = weakref.ref(st, free)
        self.live += n
        self.peak = max(self.peak, self.live)

    # ------------------------------------------------------------ collectives
    def _collective(self, func, args) -> None:
        kind = _C10D.get(func._opname)
        if kind is None:
            if not _tensors(args[:1]):
                return  # a barrier or a wait: nothing moves
            raise NotImplementedError(f"the cost count has no rule for {func}")
        nbytes = sum(_nbytes(t) for t in _tensors(args[0]))
        axis = "?"
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    group = torch.distributed.ProcessGroup.unbox(a)
                except RuntimeError:  # another script object (a ReduceOp)
                    continue
                axis = self._axes.get(group.group_name, f"group {group.group_name}")
                break
        self.collective_bytes[kind] += nbytes
        self.collective_bytes_by_axis.setdefault(axis, Counter())[kind] += nbytes
        self.hbm_bytes += nbytes

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            out = func(*args, **kwargs)
            self._collective(func, args)
            return out
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.ops += 1
        outs = _tensors(out)
        if func.namespace == KERNEL_NAMESPACE:
            self.kernel_calls[func._opname] += 1
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if func not in _NO_TRAFFIC and not func.is_view:
            self.hbm_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.hbm_bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out

    def result(self) -> dict:
        """The counts so far, per device."""
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_bytes_by_axis": {a: dict(c) for a, c in
                                         sorted(self.collective_bytes_by_axis.items())},
            "peak_bytes": self.peak,
            "argument_bytes": self.argument_bytes,
            "kernel_calls": dict(self.kernel_calls),
            "ops": self.ops,
            "loop_mult": 1,
        }


def analyze(fn, *args, arguments=(), mesh=None, **kwargs):
    """-> (``fn(*args, **kwargs)``, its :meth:`CostMode.result`); the
    ``arguments`` (and the tensors of ``args``) count as alive
    throughout."""
    mode = CostMode(arguments=(arguments, args, kwargs), mesh=mesh)
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.result()
