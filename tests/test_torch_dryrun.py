"""The port's dry run (``repro_torch/launch/dryrun.py``, ``roofline.py``)
against the JAX package's (``repro/launch/dryrun.py``, ``roofline.py``):
the batch stand-ins, the mapping and batch-sharding rules of every cell on
both production meshes, and the model FLOPs; then the kernels' meta
contracts (``kernels/ops.py``): each returns the plain version's shape and
dtype, and raises wherever the CUDA wrapper's checks raise.

JAX's rules read only ``mesh.shape`` and ``mesh.axis_names``, so they and
the port's are given a stand-in mesh with those two fields: no 512 devices
are made.  Importing the JAX dry-run module sets ``XLA_FLAGS`` to 512 host
devices; the fixture brings JAX's backend up first (so the flag changes
nothing in this process) and restores the variable after the import.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import roofline as jax_roofline  # noqa: E402
from repro_torch.configs import SHAPES, cells_for_arch, get_config, list_archs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import mpmm as mpmm_mod  # noqa: E402
from repro_torch.kernels import mqa_decode as mqa_mod  # noqa: E402
from repro_torch.launch import cost_analysis, dryrun, roofline  # noqa: E402

MESHES = {
    "pod1": SimpleNamespace(shape={"data": 16, "model": 16}, axis_names=("data", "model")),
    "pod2": SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                            axis_names=("pod", "data", "model")),
}
CELLS = [(a, s) for a in list_archs() for s in cells_for_arch(get_config(a))]


@pytest.fixture(scope="module")
def jax_dryrun():
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return mod


def test_cells_are_the_reference_cells():
    from repro.configs import cells_for_arch as jax_cells, list_archs as jax_archs

    assert CELLS == [(a, s) for a in jax_archs() for s in jax_cells(jax_config(a))]
    assert len(CELLS) == 34


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_equal_jax(jax_dryrun, arch, kind):
    """(a) batch_specs / prefix_spec (through input_specs): the same keys,
    shapes and dtypes as JAX's ShapeDtypeStructs, as meta tensors."""
    got = dryrun.input_specs(get_config(arch), SHAPES[kind])
    exp = jax_dryrun.input_specs(jax_config(arch), SHAPES[kind])
    assert sorted(got) == sorted(exp)
    for k, v in got.items():
        assert v.is_meta
        assert tuple(v.shape) == tuple(exp[k].shape), k
        assert str(v.dtype).removeprefix("torch.") == str(exp[k].dtype), k


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mapping_and_batch_axes_equal_jax(jax_dryrun, mesh):
    """(b) use_fsdp_mapping and batch_sharding_spec (both values of
    data_only) for every cell, and at batch sizes that take each of the
    rule's branches."""
    m = MESHES[mesh]
    for a, s in CELLS:
        shape = SHAPES[s]
        got = dryrun.use_fsdp_mapping(get_config(a), shape, m)
        assert got == jax_dryrun.use_fsdp_mapping(jax_config(a), shape, m), (a, s)
        for data_only in (False, True):
            assert (dryrun.batch_sharding_spec(m, shape.global_batch, data_only)
                    == jax_dryrun.batch_sharding_spec(m, shape.global_batch, data_only)), (a, s)
    for batch in (1, 2, 16, 32, 48, 256, 512):
        for data_only in (False, True):
            assert (dryrun.batch_sharding_spec(m, batch, data_only)
                    == jax_dryrun.batch_sharding_spec(m, batch, data_only)), batch
    fsdp = sum(dryrun.use_fsdp_mapping(get_config(a), SHAPES[s], m) for a, s in CELLS)
    assert fsdp == (8 if mesh == "pod1" else 0)


def test_model_flops_equal_jax():
    """(c) exactly, every cell."""
    for a, s in CELLS:
        assert roofline.model_flops(a, s) == jax_roofline.model_flops(a, s), (a, s)
    assert roofline.WIRE_FACTOR == jax_roofline.WIRE_FACTOR


def test_roofline_terms():
    """The H100 constants and the link rule: a group inside one host of 8
    runs over NVLink, any other over the network; each term is its count
    over its rate."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.HBM_BYTES) == (989e12, 3.35e12, 80e9)
    assert roofline.link_bw(range(8)) == roofline.link_bw([8, 15]) == 450e9
    assert roofline.link_bw(range(16)) == roofline.link_bw([0, 16]) == 50e9
    rec = {"arch": "llama3.2-3b", "shape": "decode_32k", "mesh": [16, 16], "ok": True,
           "flops_per_device": 989e9, "bytes_per_device": 6.7e9, "peak_bytes": 81e9,
           "collective_bytes_by_axis": {"model": {"all-reduce": 25e9},
                                        "data": {"all-gather": 1e9}},
           "axis_ranks": {"model": list(range(16)), "data": list(range(0, 256, 16))}}
    r = roofline.analyze(rec)
    assert r["t_compute_s"] == pytest.approx(1e-3)
    assert r["t_memory_s"] == pytest.approx(2e-3)
    assert r["t_collective_s"] == pytest.approx((2 * 25e9 + 1e9) / 50e9)
    assert r["dominant"] == "collective" and not r["fits"]
    assert r["links"] == {"model": "network", "data": "network"}


# ------------------------------------------------------------ meta contracts
def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


MPMM_CASES = [(4, 1, 256, 64), (4, 8, 512, 128), (8, 40, 256, 192), (8, 256, 1024, 64),
              (4, 256, 3072, 8)]


@pytest.mark.parametrize("w_bits,m,k,n", MPMM_CASES)
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_mpmm_contract_matches_plain(w_bits, m, k, n, out_dtype):
    """(e) The CF dequant matmul's contract on meta: the plain version's
    shape and dtype, one op of the kernel's FLOPs and bytes, the scratch
    the launch allocates (its K split's f32 partials), and no launch
    counted."""
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g).to(torch.bfloat16)
    wd, ws = ops.pack_weights(torch.randn(k, n, generator=g), w_bits)
    plain = ops.mpmm(x, wd, ws, w_bits=w_bits, out_dtype=out_dtype)
    before = mpmm_mod.mpmm_cuda.launches
    args = [_meta(t) for t in (x, wd, ws)]
    mode = cost_analysis.CostMode(arguments=args)
    with mode:
        got = ops.mpmm(*args, w_bits=w_bits, out_dtype=out_dtype)
    assert got.is_meta and got.shape == plain.shape and got.dtype == plain.dtype
    assert mpmm_mod.mpmm_cuda.launches == before
    out_bytes = m * n * plain.element_size()
    assert mode.peak - mode.argument_bytes == out_bytes
    out, partial, plan = mpmm_mod.launch_buffers(*args, w_bits, plain.dtype)
    assert plan == mpmm_mod.launch_plan(m, n, k, w_bits=w_bits)
    assert partial.is_meta and (partial is out if plan["splits"] == 1 else
                                (partial.shape, partial.dtype) ==
                                ((plan["splits"], m, n), torch.float32))
    flops, nbytes = mpmm_mod.mpmm_cost(m, k, n, wd.numel(), 2, plain.element_size())
    assert (mode.flops, mode.hbm_bytes) == (flops, nbytes) == (
        2 * m * n * k, m * k * 2 + k * n * w_bits // 8 + 4 * n + out_bytes)
    assert dict(mode.kernel_calls) == {"mpmm": 1}


def _mpmm_meta(m, k, n, w_bits=4, x_dtype=torch.bfloat16, kd=None, wdt=torch.int8,
               out_dtype=None):
    kd = (k // 2 if w_bits == 4 else k) if kd is None else kd
    x = torch.empty(m, k, dtype=x_dtype, device="meta")
    wd = torch.empty(kd, n, dtype=wdt, device="meta")
    ws = torch.empty(1, n, dtype=torch.float32, device="meta")
    return ops.mpmm(x, wd, ws, w_bits=w_bits, out_dtype=out_dtype)


@pytest.mark.parametrize("bad,err", [
    (dict(m=4, k=255, n=64, kd=128), "K=255 is odd"),  # int4 packs K in pairs
    (dict(m=4, k=256, n=60), "N=60 % 8"),  # 8 columns a load
    (dict(m=4, k=256, n=64, x_dtype=torch.float16), "bf16 activations"),
    (dict(m=4, k=256, n=64, kd=256), "w_data must have shape"),
    (dict(m=4, k=256, n=64, wdt=torch.int16), "w_data must be torch.int8"),
])
def test_mpmm_contract_raises_as_the_wrapper(bad, err):
    """(e) Each check of the CUDA wrapper (and of ``ops.mpmm`` before it)
    raises on meta; the plain version takes the same shapes where it can."""
    with pytest.raises((ValueError, TypeError), match=err):
        _mpmm_meta(**bad)


def test_mpmm_wrapper_contract_needs_k():
    """``ops.mpmm`` cannot reshape an empty K on any device; the kernel's
    own check raises in its contract as on the card."""
    x = torch.empty(4, 0, dtype=torch.bfloat16, device="meta")
    wd = torch.empty(0, 64, dtype=torch.int8, device="meta")
    ws = torch.empty(1, 64, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="K >= 1"):
        mpmm_mod.mpmm_contract(x, wd, ws, w_bits=8)


def test_mpmm_w16_dequant_raises_on_every_device():
    with pytest.raises(ValueError, match="w16 requires int mode"):
        _mpmm_meta(4, 64, 64, w_bits=16, kd=64, wdt=torch.int16)


MQA_CASES = [(2, 40, 2, 3, 64, 8), (1, 600, 4, 1, 112, 8), (3, 24, 1, 8, 128, 4)]


@pytest.mark.parametrize("b,s,hkv,g,d,kv_bits", MQA_CASES)
def test_mqa_decode_contract_matches_plain(b, s, hkv, g, d, kv_bits):
    """(e) Contiguous-cache decode's contract on meta: the plain version's
    shape and dtype, one op of the kernel's FLOPs and bytes, the split
    buffer of its plan, and no launch counted."""
    gen = torch.Generator().manual_seed(s)
    q = torch.randn(b, hkv * g, d, generator=gen).to(torch.bfloat16)
    kd, ks = ops.quantize_kv(torch.randn(b, s, hkv, d, generator=gen), kv_bits)
    vd, vs = ops.quantize_kv(torch.randn(b, s, hkv, d, generator=gen), kv_bits)
    lengths = torch.full((b,), s, dtype=torch.int32)
    plain = ops.mqa_decode(q, kd, vd, ks, vs, lengths, kv_bits=kv_bits)
    before = mqa_mod.mqa_decode_cuda.launches
    args = [_meta(t) for t in (q, kd, vd, ks, vs, lengths)]
    mode = cost_analysis.CostMode(arguments=args)
    with mode:
        got = ops.mqa_decode(*args, kv_bits=kv_bits)
    assert got.is_meta and got.shape == plain.shape and got.dtype == plain.dtype
    assert mqa_mod.mqa_decode_cuda.launches == before
    assert mode.peak - mode.argument_bytes == q.numel() * 2
    flops, nbytes = mqa_mod.decode_cost(b, hkv, g, d, b * s, kv_bits)
    assert (mode.flops, mode.hbm_bytes) == (flops, nbytes)
    assert flops == 4 * b * hkv * g * d * s
    qg = args[0].reshape(b, hkv, g, d)
    out, part, plan = mqa_mod.launch_buffers(qg, *args[1:], kv_bits)
    assert plan == mqa_mod.decode_plan(b, hkv, g, s)
    assert part.is_meta and (part is out if plan["splits"] == 1 else
                             (part.shape, part.dtype) ==
                             ((b, hkv, plan["splits"], g * (d + 2)), torch.float32))
    assert dict(mode.kernel_calls) == {"mqa_decode": 1}


def _mqa_meta(b=2, s=16, hkv=2, g=2, d=64, kv_bits=8, q_dtype=torch.bfloat16, dk=None,
              scale_shape=None):
    dk = (d // 2 if kv_bits == 4 else d) if dk is None else dk
    q = torch.empty(b, hkv * g, d, dtype=q_dtype, device="meta")
    kv = torch.empty(b, s, hkv, dk, dtype=torch.int8, device="meta")
    sc = torch.empty(scale_shape or (b, s, hkv, 1), dtype=torch.float32, device="meta")
    lengths = torch.empty(b, dtype=torch.int32, device="meta")
    return ops.mqa_decode(q, kv, kv, sc, sc, lengths, kv_bits=kv_bits)


@pytest.mark.parametrize("bad,err", [
    (dict(d=260), "head dims up to 256"),
    (dict(kv_bits=16), "kv_bits must be 4 or 8"),
    (dict(q_dtype=torch.float16), "q must be bfloat16 or float32"),
    (dict(d=6, kv_bits=4), "whole 32-bit words"),
    (dict(dk=32), "k_data must have shape"),
    (dict(scale_shape=(2, 16, 2, 2)), "k_scale must have shape"),
])
def test_mqa_decode_contract_raises_as_the_wrapper(bad, err):
    with pytest.raises((ValueError, TypeError), match=err):
        _mqa_meta(**bad)


@pytest.mark.parametrize("d,kv_bits,err", [
    (256, 8, None), (256, 4, None), (258, 8, "whole 32-bit words"),
    (264, 4, "head dims up to 256"), (255, 8, "whole 32-bit words"),
])
def test_mqa_decode_contract_takes_head_dims_up_to_256(d, kv_bits, err):
    """The contract takes paligemma-3b's head dim 256 (1 kv head x 8
    queries, the wide instantiation: groups of 2 queries), and still
    refuses D 258 (rows of 258 bytes), D 264 at kv4 (whole words, past the
    bound) and an odd D."""
    if err is not None:
        with pytest.raises(ValueError, match=err):
            _mqa_meta(b=8, s=64, hkv=1, g=8, d=d, kv_bits=kv_bits)
        return
    out = _mqa_meta(b=8, s=64, hkv=1, g=8, d=d, kv_bits=kv_bits)
    assert out.is_meta and tuple(out.shape) == (8, 8, d) and out.dtype == torch.bfloat16
    assert mqa_mod.decode_plan(8, 1, 8, 64, d)["groups"] == 4


def test_paligemma_decode_32k_traces_on_both_meshes(tmp_path, monkeypatch):
    """The dry run's paligemma-3b ``decode_32k`` cell (mqa_decode at head dim
    256, one rank's rows of the full 32k cache) traces to its end on the
    16 x 16 and the 2 x 16 x 16 mesh, with one mqa_decode call a layer."""
    from repro_torch.launch.mesh import make_production_mesh

    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    for multi_pod, size in ((False, 256), (True, 512)):
        with dryrun.fake_world(size):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            rec = dryrun.run_cell("paligemma-3b", "decode_32k", multi_pod, mesh, force=True)
        assert rec["ok"], rec.get("error")
        assert rec["kernel_calls"]["mqa_decode"] == get_config("paligemma-3b").n_layers
        assert rec["flops_per_device"] > 0 and rec["peak_bytes"] < 80e9


def test_dispatch_cpu_plain_meta_contract():
    """A CPU tensor gets the plain version (its values), a meta tensor the
    contract (no values, no launch), through the kernel's operator; a
    kernel with no contract (paged decode) raises on meta.  The card's side
    (a CUDA tensor launches) is ``tests/test_torch_cuda.py``'s."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 64, generator=g).to(torch.bfloat16)
    wd, ws = ops.pack_weights(torch.randn(64, 16, generator=g), 8)
    np.testing.assert_array_equal(ops.mpmm(x, wd, ws, w_bits=8).float().numpy(),
                                  ref.mpmm_ref(x, wd, ws, w_bits=8).float().numpy())
    contract = ops.mpmm(*(_meta(t) for t in (x, wd, ws)), w_bits=8)
    assert contract.is_meta and contract.shape == (3, 16)
    assert not ops.on_card(x)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.on_card(_meta(x))
    q = torch.empty(2, 4, 64, dtype=torch.bfloat16, device="meta")
    pool = torch.empty(1, 4, 16, 2, 64, dtype=torch.int8, device="meta")
    scale = torch.empty(1, 4, 16, 2, 1, device="meta")
    new = torch.empty(2, 2, 64, dtype=torch.int8, device="meta")
    new_s = torch.empty(2, 2, 1, device="meta")
    tables = torch.empty(2, 4, dtype=torch.int32, device="meta")
    lengths = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version for device meta"):
        ops.paged_mqa_decode(q, pool, pool, scale, scale, tables, lengths, 0, new, new,
                             new_s, new_s, kv_bits=8)


def test_shape_only_params_equal_real_shapes():
    """``meta_params`` (no draw) has the real params' tree, shapes and
    dtypes, quantized too, for a reduced config of every family."""
    from repro_torch.models import transformer as model_lib
    from repro_torch.optim import tree

    for arch in ("llama3.2-3b", "mixtral-8x22b", "zamba2-7b", "kimi-k2-1t-a32b"):
        cfg = get_config(arch).reduced()
        for bits in (None, 4, 8):
            real = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
            if bits:
                real = model_lib.quantize_params(real, bits)
            meta = dryrun.meta_params(cfg, bits)
            assert sh_tree(real) == sh_tree(meta), (arch, bits)
            assert all(t.is_meta for t in tree.leaves(meta) if torch.is_tensor(t))


def sh_tree(t):
    if isinstance(t, dict):
        return {k: sh_tree(v) for k, v in t.items()}
    return (tuple(t.shape), t.dtype) if torch.is_tensor(t) else t
