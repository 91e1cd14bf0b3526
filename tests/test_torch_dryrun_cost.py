"""The port's cost count (``repro_torch/launch/cost_analysis.py``) against
the JAX package's HLO analysis (``repro/launch/hlo_analysis.py``) on the
same single-device cells: reduced configs, batch 4 x 128.

JAX: ``analyze_hlo`` of the compiled program (one CPU device) of
``jax.value_and_grad(train_loss)`` with ``remat="none"`` for llama3.2-3b and
mixtral-8x22b, and of ``prefill`` / ``decode_step`` on W4 params in bf16
for llama3.2-3b (its contiguous cache of 128).  The port: ``CostMode``
around ``trainer.value_and_grad``, ``transformer.prefill`` and
``decode_step`` on the same configs' shape-only (meta) params, where the
W4 projections and the quantized decode attention count as their kernels'
cost functions (``kernels/mpmm.py::mpmm_cost``,
``kernels/mqa_decode.py::decode_cost``).

Held within 3% (``RTOL``).  Prefill and decode agree exactly.  The train
cells differ by one op: the port's ``layers.chunked_cross_entropy`` runs
each chunk under ``torch.utils.checkpoint``, so its backward recomputes the
chunk's logits product, 2 x tokens x d_model x vocab = 2^26 FLOPs here,
which JAX's ``lax.scan`` keeps as a residual instead; the test pins that
difference too.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models import transformer as jax_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_specs  # noqa: E402
from repro_torch.launch import cost_analysis, dryrun  # noqa: E402
from repro_torch.models import transformer as model_lib  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

B, S = 4, 128
RTOL = 0.03
CASES = [("llama3.2-3b", "train"), ("mixtral-8x22b", "train"), ("llama3.2-3b", "prefill"),
         ("llama3.2-3b", "decode")]


def _configs(arch, kind):
    over = dict(remat="none") if kind == "train" else dict(dtype="bfloat16", serve_w_bits=4)
    return (dataclasses.replace(jax_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _jax_flops(arch, kind) -> float:
    cfg = _configs(arch, kind)[0]
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jnp.zeros((B, S), jnp.int32)
    if kind == "train":
        fn = jax.value_and_grad(lambda p, b: jax_model.train_loss(p, b, cfg)[0])
        lowered = jax.jit(fn).lower(params, {"tokens": tokens, "labels": tokens})
    else:
        qp = jax_model.quantize_params(params, cfg.serve_w_bits)
        if kind == "prefill":
            lowered = jax.jit(lambda p, b: jax_model.prefill(p, b, cfg, S)).lower(
                qp, {"tokens": tokens})
        else:
            lowered = jax.jit(lambda p, t, c: jax_model.decode_step(p, t, c, cfg)).lower(
                qp, tokens[:, :1], jax_model.init_cache(cfg, B, S))
    return analyze_hlo(lowered.compile().as_text())["flops"]


@pytest.fixture(scope="module")
def jax_flops():
    return {case: _jax_flops(*case) for case in CASES}


def _port_cost(arch, kind) -> dict:
    cfg = _configs(arch, kind)[1]
    if kind == "train":
        params = dryrun.meta_params(cfg)
        batch = batch_specs(DataConfig(cfg.vocab, S, B), cfg)
        return cost_analysis.analyze(trainer.value_and_grad, params, batch, cfg)[1]
    params = dryrun.meta_params(cfg, cfg.serve_w_bits)
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    if kind == "prefill":
        return cost_analysis.analyze(model_lib.prefill, params, {"tokens": tokens}, cfg, S)[1]
    cache = model_lib.init_cache(cfg, B, S, "meta")
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    return cost_analysis.analyze(model_lib.decode_step, params, tokens, cache, cfg)[1]


@pytest.mark.parametrize("arch,kind", CASES)
def test_flops_match_hlo_analysis(jax_flops, arch, kind):
    cost = _port_cost(arch, kind)
    exp = jax_flops[(arch, kind)]
    assert cost["flops"] == pytest.approx(exp, rel=RTOL)
    cfg = _configs(arch, kind)[1]
    if kind == "train":
        recompute = 2 * B * S * cfg.d_model * cfg.padded_vocab
        assert cost["flops"] - exp == recompute == 2**26
    else:
        assert cost["flops"] == exp
        calls = {"mpmm": cfg.n_layers * 7 + 1}
        if kind == "decode":
            calls["mqa_decode"] = cfg.n_layers
        assert cost["kernel_calls"] == calls


def test_same_count_on_cpu_and_meta():
    """The count is device-independent: reduced llama3.2-3b's W4 decode
    step on real CPU tensors (the kernels' plain versions run) counts the
    meta trace's FLOPs and kernel calls, and the kernels' inner ops add
    none."""
    cfg = _configs("llama3.2-3b", "decode")[1]
    params = model_lib.quantize_params(
        model_lib.init_params(cfg, torch.Generator().manual_seed(0)), 4)
    cache = model_lib.init_cache(cfg, B, S, "cpu")
    tokens = torch.zeros((B, 1), dtype=torch.int32)
    cpu = cost_analysis.analyze(model_lib.decode_step, params, tokens, cache, cfg)[1]
    meta = _port_cost("llama3.2-3b", "decode")
    for key in ("flops", "hbm_bytes", "kernel_calls", "argument_bytes"):
        assert cpu[key] == meta[key], key
