"""The port's dry run on fake process groups (``repro_torch/launch/dryrun.py``):
reduced cells trace end to end on a 4 x 4 mesh, an FSDP cell's per-device
FLOPs are the single-device count over the mesh size, and one dense
layer's TP collectives equal a count by hand.

Each test makes its own ``fake`` group (``dryrun.fake_world``), in this
process, and removes it: its collectives return at once and move nothing,
and every tensor is a meta tensor.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_specs  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.elastic import reshard_state  # noqa: E402
from repro_torch.launch import cost_analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as model_lib  # noqa: E402
from repro_torch.train.trainer import TrainConfig, make_train_step  # noqa: E402


def _reduced(arch):
    return dataclasses.replace(get_config(arch).reduced(), remat="none")


@pytest.mark.parametrize("arch,kind", [("llama3.2-3b", "train"), ("yi-9b", "decode"),
                                       ("mamba2-130m", "decode"),
                                       ("kimi-k2-1t-a32b", "train")])
def test_small_mesh_cell(arch, kind):
    """(f) The cells of ``tests/test_dryrun_small.py`` (reduced, S 128, B 8)
    on a 4 x 4 mesh: each traces to its end, with FLOPs and collective
    bytes, as the JAX test asserts of its compile."""
    with dryrun.fake_world(16):
        mesh = make_mesh((4, 4), ("data", "model"), device="cpu")
        rec = dryrun.dry_run(_reduced(arch), ShapeSpec("t", 128, 8, kind), mesh)
    assert rec["mapping"] == "tp" and rec["rows"] == 2
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert sum(rec["collective_bytes"].values()) > 0, "a sharded model must communicate"
    assert rec["peak_bytes"] >= rec["argument_size_in_bytes"] > 0
    if kind == "decode":
        assert rec["cache_bytes"] > 0
    assert sh.get_mesh() is None


def test_fsdp_flops_split_over_the_mesh():
    """(g) llama3.2-3b's train cell under the FSDP mapping on a 2 x 2 mesh
    (B 8: 2 rows a rank, the weights gathered whole): rank 0's FLOPs times 4
    are the single-device step's within 1%."""
    arch, shape = _reduced("llama3.2-3b"), ShapeSpec("t", 128, 8, "train")
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        rec = dryrun.dry_run(arch, shape, mesh)
    assert rec["mapping"] == "fsdp" and rec["rows"] == 2
    step_fn, opt_init = make_train_step(arch, TrainConfig(microbatches=1))
    params = dryrun.meta_params(arch)
    opt_state = opt_init(params)
    batch = batch_specs(DataConfig(arch.vocab, 128, 8), arch)
    _, single = cost_analysis.analyze(step_fn, params, opt_state, batch, 0)
    assert rec["flops_per_device"] * 4 == pytest.approx(single["flops"], rel=0.01)
    assert sum(single["collective_bytes"].values()) == 0


def test_dense_layer_tp_collectives_by_hand():
    """(h) One reduced llama3.2-3b layer (attention, then the MLP; bf16, B 8
    x S 16, 4 heads of 32 over 2 kv heads, F 256) under the TP mapping on a
    2 x 2 (data, model) mesh: forward and backward of ``x + attn(x)`` then
    ``+ mlp``, every weight requiring grad.  Where ``sharding.py`` puts
    its collectives:

    * each of the 7 weights is stored 2-D (rules ("data", "model") for wq,
      wk, wv, wg, wu; ("model", "data") for wo, wd) and used as its model
      block on the dim the model axis already splits (kv heads and F divide
      by 2), so ``_GatherTP`` gathers it over ``data`` only: an all-gather
      whose output is the model block, numel / 2 bf16 elements; its
      backward sums that block's gradient over the batch axes: an
      all-reduce over ``data`` of the same bytes;
    * the row-split products (wo, wd) sum their f32 partials over
      ``model`` (g): two all-reduces of [b, S, D] f32, b = 4 rows a rank;
    * each column-split product (wq, wk, wv, wg, wu) enters through f,
      whose backward all-reduces its input's bf16 gradient over ``model``:
      five [b, S, D] bf16 all-reduces.
    Nothing else communicates: RoPE, attention and the norms are local."""
    arch = _reduced("llama3.2-3b")
    b, s, d = 4, 16, arch.d_model
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        with sh.use_mesh(mesh):
            blocks = reshard_state(dryrun.meta_params(arch), mesh)["blocks"]
            p = model_lib.layer_params(blocks, 0)
            weights = [p[k] for k in ("wq", "wk", "wv", "wo")] + [
                p["mlp"][k] for k in ("wg", "wu", "wd")]
            for w in weights:
                w.requires_grad_(True)
            x = torch.empty((b, s, d), dtype=torch.bfloat16, device="meta",
                            requires_grad=True)
            pos = torch.arange(s, device="meta").expand(b, s)

            def layer():
                a, _, _ = model_lib._attn_block(p, x, pos, arch, None)
                y = x + a
                y = y + model_lib._mlp_block(p, y, arch)
                return torch.autograd.grad(y.sum(), [x, *weights])

            _, cost = cost_analysis.analyze(layer, arguments=(p, x), mesh=mesh)
    # a model block: half of each weight's elements, 2 bytes each
    blocks_bytes = sum(math.prod(sh.full_shape(w)) // 2 * 2 for w in weights)
    act = b * s * d
    assert cost["collective_bytes_by_axis"] == {
        "data": {"all-gather": blocks_bytes, "all-reduce": blocks_bytes},
        "model": {"all-reduce": 2 * act * 4 + 5 * act * 2},
    }
