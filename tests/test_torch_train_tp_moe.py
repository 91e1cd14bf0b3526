"""MoE training under the tensor-parallel (TP) mapping: the port's mesh step
on reduced mixtral-8x22b against the JAX package's own TP step, on 4 gloo
ranks, by ``test_torch_train_tp.py``'s procedure and rules (its module
note), plus the assignments dropped at capacity in every MoE layer of each
evaluation's forward, equal to JAX's.

Capacity factor 1.0 (both frameworks' configs), so capacity binds in every
layer: the drops show that the port's routing order and capacity are the
global batch's, as under SPMD, while each rank holds its rows.  The 8
experts split over the model axis on 2 x 2 and on 1 x 4 (each model rank
runs its E / M experts; the combine sums over ``model``); with 6 experts on
1 x 4 the model axis does not divide them, and the experts' F splits
instead (``wg`` / ``wu`` columns, ``wd`` rows).  Tolerance rtol = atol =
1e-5 on the metrics, every gradient leaf and the parameters.
"""
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from test_torch_train_tp import hold, run_cases  # noqa: E402

CF = {"capacity_factor": 1.0}
CASES = [("mixtral-8x22b", CF, (2, 2)), ("mixtral-8x22b", CF, (1, 4)),
         ("mixtral-8x22b", {**CF, "n_experts": 6}, (1, 4))]


@pytest.fixture(scope="module")
def results(tmp_path_factory, subproc):
    return run_cases(CASES, tmp_path_factory.mktemp("train_tp_moe"), subproc)


@pytest.mark.parametrize("name,over,shape", CASES,
                         ids=["experts-2x2", "experts-1x4", "expert-F-1x4"])
def test_moe_tp_step_matches_jax_tp_step(name, over, shape, results):
    hold(results, name, over, shape, moe=True)
