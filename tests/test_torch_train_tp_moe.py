"""MoE training under the tensor-parallel (TP) mapping: the port's mesh step
on reduced mixtral-8x22b against the JAX package's own TP step, on 4 gloo
ranks, by ``test_torch_train_tp.py``'s procedure and rules (its module
note), plus the assignments dropped at capacity in every MoE layer of each
evaluation's forward, equal to JAX's.

Capacity factor 1.0 (both frameworks' configs), so capacity binds in every
layer.  The replicated dispatch: the drops show that the port's routing
order and capacity are the global batch's, as under SPMD, while each rank
holds its rows.  The 8 experts split over the model axis on 2 x 2 and on 1
x 4 (each model rank runs its E / M experts; the combine sums over
``model``); with 6 experts on 1 x 4 the model axis does not divide them,
and the experts' F splits instead (``wg`` / ``wu`` columns, ``wd`` rows).
The all-to-all dispatch (``moe_dispatch="alltoall"``; the JAX script passes
the mesh to ``train_loss`` and ``make_train_step`` for these cases, as
JAX's ``Trainer(mesh=)`` does): each data shard routes its own tokens with
its own capacity, and the drops of every data shard equal JAX's; the
gradient goes back through both all-to-alls.  With 6 experts on 1 x 4 it
raises ``ValueError`` in both packages (JAX's ``shard_map``: the expert
leaves' E not evenly divisible by the model axis).  Tolerance rtol = atol =
1e-5 on the metrics, every gradient leaf and the parameters.
"""
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from test_torch_train_tp import hold, run_cases  # noqa: E402

CF = {"capacity_factor": 1.0}
A2A = {**CF, "moe_dispatch": "alltoall"}
CASES = [("mixtral-8x22b", CF, (2, 2)), ("mixtral-8x22b", CF, (1, 4)),
         ("mixtral-8x22b", {**CF, "n_experts": 6}, (1, 4)),
         ("mixtral-8x22b", A2A, (2, 2)), ("mixtral-8x22b", A2A, (1, 4))]
RAISING = [("mixtral-8x22b", {**A2A, "n_experts": 6}, (1, 4))]


@pytest.fixture(scope="module")
def results(tmp_path_factory, subproc):
    return run_cases(CASES, tmp_path_factory.mktemp("train_tp_moe"), subproc, RAISING)


@pytest.mark.parametrize("name,over,shape", CASES,
                         ids=["experts-2x2", "experts-1x4", "expert-F-1x4", "alltoall-2x2",
                              "alltoall-1x4"])
def test_moe_tp_step_matches_jax_tp_step(name, over, shape, results):
    hold(results, name, over, shape, moe=True)


def test_alltoall_experts_not_dividing_the_model_axis_raise(results):
    (theirs, ours), = results["raised"].values()
    assert theirs is not None and ours is not None, (theirs, ours)
    assert theirs.startswith("ValueError") and "not evenly divisible" in theirs, theirs
    assert ours.startswith("ValueError") and "6 experts do not divide over 4" in ours, ours
