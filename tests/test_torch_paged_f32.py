"""Float32 configs of the paged engine: what the f32 instantiations of the
paged decode and paged prefill kernels take, held against the JAX package.

(a) The pool types: for ``cfg.dtype`` in {bfloat16, float32} and kv_bits in
{4, 8, 16}, JAX's ``PagedKVCache`` payload equals the port's and equals
what ``kernels._checks.paged_dtypes`` says the kernels take (a kv16 pool
holds the model's float type; kv8 / kv4 int8 payloads with f32 scales; the
output is the query's type).  The plain versions on f32 queries and f32
pools against JAX's Pallas kernels in interpret mode, within the f32
kernels' tolerance (``atol = rtol = 1e-4``).
(b) Launch geometry, as pure functions: every instantiation's shared memory
within the H100's 227 KB a block, pool rows of whole 32-bit words, and the
grids covering every (row, kv head, query row) and every decode warp unit
once.
(c) The smoke's mixed float32 engine traffic at reduced size against JAX's
float32 engine: (w, kv) over (4,8) (8,4) (8,8) (16,16), greedy and sampled
requests, speculation on half of them, one JAX run shared by the module:
equal streams and counters, and a second port run repeating every stream.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs import get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.quant.pack import pack_int4 as jpack_int4  # noqa: E402
from repro.serve import PrecisionParams as JPrecision  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.kv_cache import PagedKVCache as JCache  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode as pd  # noqa: E402
from repro_torch.kernels import paged_prefill as pf  # noqa: E402
from repro_torch.kernels._checks import paged_dtypes  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import torch_dtype  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.serve.params import PrecisionParams, SamplingParams  # noqa: E402

F32_TOL = dict(atol=1e-4, rtol=1e-4)
SMEM_MAX = 227 * 1024


def _name(dtype) -> str:
    """A torch or numpy / JAX dtype's name: 'bfloat16', 'float32', 'int8'."""
    return str(dtype).removeprefix("torch.")


# ------------------------------------------------------------ (a) pool types
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_pool_types_match_jax_and_the_kernels(dtype, kv_bits):
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype=dtype)
    tcfg = dataclasses.replace(tget("llama3.2-3b").reduced(), dtype=dtype)
    theirs = JCache(cfg, num_pages=4, page_size=4, kv_bits=kv_bits)
    ours = PagedKVCache(tcfg, num_pages=4, page_size=4, kv_bits=kv_bits, device="cpu")
    pool, out = paged_dtypes(torch_dtype(dtype), kv_bits)
    for j, t in ((theirs.k, ours.k), (theirs.v, ours.v)):
        assert _name(j.dtype) == _name(t.dtype) == _name(pool)
        assert tuple(j.shape) == tuple(t.shape)
    for j, t in ((theirs.k_scale, ours.k_scale), (theirs.v_scale, ours.v_scale)):
        assert (j is None) == (t is None) == (kv_bits == 16)
        if t is not None:
            assert _name(j.dtype) == _name(t.dtype) == "float32"
    assert out == torch_dtype(dtype)


def test_paged_dtypes_refuse_other_query_types():
    for dt in (torch.float16, torch.int8, torch.float64):
        with pytest.raises(TypeError, match="bf16 or float32"):
            paged_dtypes(dt, 8)
    with pytest.raises(ValueError, match="kv_bits"):
        paged_dtypes(torch.float32, 2)


def _payload(rng, shape, kv_bits):
    """(payload as an f32 model's pool stores it, per-token scales or None)."""
    if kv_bits == 16:
        return rng.normal(size=shape).astype(np.float32), None
    lim = 8 if kv_bits == 4 else 128
    x = rng.integers(-lim, lim, shape).astype(np.int8)
    s = (rng.random((*shape[:-1], 1)) * 0.1).astype(np.float32)
    if kv_bits == 4:
        x = np.asarray(jpack_int4(jnp.asarray(x), axis=-1))
    return x, s


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 9])
def test_plain_paged_decode_on_f32_matches_pallas(kv_bits, window):
    """An f32 query over an f32 model's pools: the plain version's f32
    output within 1e-4 of JAX's Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(kv_bits + (window or 0))
    b, hkv, g, d, ps, w, n_layers = 3, 2, 3, 32, 4, 6, 2
    n_pages = b * w + 2
    kp, ks = _payload(rng, (n_layers, n_pages, ps, hkv, d), kv_bits)
    vp, vs = _payload(rng, (n_layers, n_pages, ps, hkv, d), kv_bits)
    nk, nks = _payload(rng, (b, hkv, d), kv_bits)
    nv, nvs = _payload(rng, (b, hkv, d), kv_bits)
    q = rng.normal(size=(b, hkv * g, d)).astype(np.float32)
    tables = rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)
    lengths = np.array([0, ps + 3, w * ps], np.int32)
    args = (q, kp, vp, ks, vs, tables, lengths, 1, nk, nv, nks, nvs)
    got = ops.paged_mqa_decode(*map(_t, args), kv_bits=kv_bits, window=window)
    assert got.dtype == torch.float32
    exp = jops.paged_mqa_decode(*map(_j, args), kv_bits=kv_bits, window=window,
                                backend="pallas", interpret=True)
    assert exp.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **F32_TOL)


@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("c", [1, 5])
def test_plain_paged_prefill_on_f32_matches_pallas(kv_bits, c):
    """The same for a chunk (C 1) and a verify window (C 5), ragged q_lens
    and a padding row; rows past q_len are padding both sides drop."""
    rng = np.random.default_rng(10 * kv_bits + c)
    b, hkv, g, d, ps, w, n_layers = 3, 2, 2, 32, 4, 6, 2
    n_pages = b * w + 1
    kp, ks = _payload(rng, (n_layers, n_pages, ps, hkv, d), kv_bits)
    vp, vs = _payload(rng, (n_layers, n_pages, ps, hkv, d), kv_bits)
    ck, cks = _payload(rng, (b, c, hkv, d), kv_bits)
    cv, cvs = _payload(rng, (b, c, hkv, d), kv_bits)
    q = rng.normal(size=(b, c, hkv * g, d)).astype(np.float32)
    tables = rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)
    ctx = np.array([5, 0, 11], np.int32)
    q_lens = np.array([c, max(c - 2, 1), 0], np.int32)
    args = (q, kp, vp, ks, vs, tables, ctx, q_lens, 1, ck, cv, cks, cvs)
    got = ops.paged_mqa_prefill(*map(_t, args), kv_bits=kv_bits)
    assert got.dtype == torch.float32
    exp = jops.paged_mqa_prefill(*map(_j, args), kv_bits=kv_bits, backend="pallas",
                                 interpret=True)
    live = np.arange(c)[None, :] < q_lens[:, None]
    np.testing.assert_allclose(got.numpy()[live], np.asarray(exp)[live], **F32_TOL)


# ---------------------------------------------------------- (b) geometry
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_prefill_instantiations_fit_shared_memory(itemsize, kv_bits):
    """Every (DP, kv_bits, row warps) of both query types fits a block's
    227 KB; the f32 ones take 64-key tiles but at DP 256 where those would
    not fit (64 rows of kv8 or kv16, every kv16), and the bf16 numbers are
    the source note's."""
    for dp in pf.HEAD_DIMS:
        for rw in ((1, 2, 4) if itemsize == 4 else (4,)):
            assert pf.smem_bytes(dp, kv_bits, itemsize, rw) <= SMEM_MAX
            kt = pf.keys_per_tile(dp, itemsize, kv_bits, rw)
            assert kt == 64 or (itemsize, dp) == (4, 256)
            if kt == 32:
                assert pf._f32_bytes(dp, kv_bits, rw, 64) > SMEM_MAX
    if itemsize == 4:
        assert [pf.keys_per_tile(256, 4, kv_bits, rw) for rw in (1, 2, 4)] == {
            4: [64, 64, 64], 8: [64, 64, 32], 16: [32, 32, 32]}[kv_bits]
    assert {k: pf.smem_bytes(256, k, 2) for k in (16, 8, 4)} == {
        16: 168960, 8: 201728, 4: 152576}
    assert {k: pf.smem_bytes(256, k, 4) for k in (16, 8, 4)} == {
        16: 200704, 8: 185344, 4: 220160}


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_decode_blocks_fit_shared_memory_and_rows_are_words(itemsize, kv_bits):
    """At every even D the kernels take, a pool row is whole 32-bit words
    (kv8 / kv4 need D % 4 / 8), the block's rings fit 227 KB, and only f32
    pools past D 128 drop to fewer than four warps a block."""
    for d in range(2, 257, 2):
        dk = d * itemsize if kv_bits == 16 else d * kv_bits // 8
        if (d * kv_bits) % 32 and kv_bits < 16:
            continue  # int rows of a partial word: refused
        assert dk % 4 == 0
        warps = pd.block_warps(d, kv_bits, itemsize)
        assert pd.decode_smem_bytes(d, kv_bits, itemsize, warps) <= SMEM_MAX
        if (itemsize, kv_bits) != (4, 16) or d <= 128:
            assert warps == pd.BLOCK_WARPS
        if warps < pd.BLOCK_WARPS:
            assert pd.decode_smem_bytes(d, kv_bits, itemsize, 2 * warps) > SMEM_MAX


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("c,g", [(1, 3), (5, 3), (128, 3), (5, 8), (128, 4), (65, 1)])
def test_prefill_grid_covers_every_row_once(itemsize, c, g):
    """Each (row, kv head, query row r = c * G + g) falls in exactly one
    row block of the plan's grid, whose z is row blocks x splits (bf16: 64
    rows, one split; f32: 16, 32 or 64 rows)."""
    b, hkv = 3, 2
    plan = pf.prefill_plan(b, hkv, c, g, 64, 20, 16, None, 8, itemsize)
    gb, gh, gz = plan["grid"]
    rb, splits = plan["rows_per_block"], plan["splits"]
    assert (gb, gh) == (b, hkv) and gz % splits == 0
    assert plan["row_warps"] == pf.row_warps(c * g, itemsize) and rb == 16 * plan["row_warps"]
    if itemsize == 2:
        assert (gb, gh, gz) == pf.launch_grid(b, hkv, c, g) and splits == 1
    seen = np.zeros((b, hkv, c * g), np.int64)
    for bi in range(gb):
        for hi in range(gh):
            for z in range(gz // splits):
                seen[bi, hi, z * rb:(z + 1) * rb] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b,hkv,g,d,c,w,ps,window", [
    (8, 8, 3, 128, 5, 65, 16, None), (8, 1, 8, 256, 5, 51, 16, None),
    (4, 1, 4, 256, 128, 105, 16, 1024), (4, 8, 3, 128, 128, 33, 16, None),
    (3, 2, 4, 64, 6, 22, 16, 40), (2, 2, 1, 32, 9, 5, 16, None),
    (5, 1, 2, 192, 300, 82, 16, 256), (1, 4, 3, 128, 2048, 129, 16, None)])
@pytest.mark.parametrize("kv_bits", [4, 8, 16])
def test_prefill_plan_covers_every_query_key_once(b, hkv, g, d, c, w, ps, window, kv_bits):
    """The f32 plan's splits and key warps take every key a query row can
    see exactly once: for ragged ctx (0, mid-page, the table's end) and
    q_len (0, 1, C), each row block's splits (``split_tiles``, the kernel's
    on-card split) are consecutive runs of its tiles in order, the merge's
    order, and each tile's ``key_warps`` ranges of ``keys_per_tile //
    key_warps`` keys partition it; a row's visible keys (pool positions in
    its window below ctx, chunk keys up to its own, below q_len) are each
    covered by one (split, tile, key warp)."""
    plan = pf.prefill_plan(b, hkv, c, g, d, w, ps, window, kv_bits, 4)
    rb, kt, kw_n, splits = (plan["rows_per_block"], plan["keys_per_tile"], plan["key_warps"],
                            plan["splits"])
    kw = kt // kw_n
    assert kw >= 16 and kw_n * kw == kt and 1 <= splits <= pf.MAX_SPLITS
    assert plan["grid"][2] == -(-c * g // rb) * splits
    rng = np.random.default_rng(c + d)
    cap = w * ps
    for ctx, q_len in [(0, c), (cap - c, c), (int(rng.integers(0, cap - c)), 1),
                       (int(rng.integers(1, cap - c)), 0), (ps + 3, max(c // 2, 1))]:
        for r0 in range(0, c * g, rb):
            nr = min(rb, c * g - r0)
            runs = pf.split_tiles(ctx, q_len, r0, nr, g, w, ps, window, kt, splits)
            assert 1 <= len(runs) <= splits
            tiles = [t for run in runs for t in run]
            assert tiles == sorted(tiles, key=lambda t: (t[0] == "chunk", t[1]))
            covered = {}
            for s, run in enumerate(runs):
                for kind, first, end in run:
                    assert 0 < end - first <= kt
                    for kp in range(kw_n):
                        for key in range(first + kp * kw, min(first + (kp + 1) * kw, end)):
                            covered[(kind, key)] = covered.get((kind, key), 0) + 1
            assert all(n == 1 for n in covered.values())
            for r in range(r0, r0 + nr):
                ci = r // g
                lo = max(ctx + ci + 1 - window, 0) if window else 0
                seen = {("pool", p) for p in range(lo, min(ctx, cap))}
                jlo = max(ci + 1 - window, 0) if window else 0
                seen |= {("chunk", j) for j in range(jlo, min(ci + 1, q_len))}
                assert seen <= covered.keys()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("b,hkv,g,d,w,ps,window", [
    (8, 8, 3, 128, 65, 16, None), (8, 1, 4, 256, 129, 16, 1024), (8, 1, 8, 256, 50, 16, None),
    (5, 2, 3, 192, 20, 16, 200), (1, 24, 1, 64, 40, 16, None)])
def test_decode_grid_covers_every_unit_once(itemsize, b, hkv, g, d, w, ps, window):
    """The plan's blocks of ``block_warps`` warps hold every (kv head, query
    group, split) unit of a row once, with fewer than a block left over,
    and its splits cover the span in whole tiles."""
    plan = pd.decode_plan(b, hkv, g, d, w, ps, window, 16, itemsize)
    units = hkv * plan["groups"] * plan["splits"]
    gb, gy = plan["grid"]
    warps = plan["block_warps"]
    assert gb == b and gy * warps >= units > (gy - 1) * warps
    assert warps == pd.block_warps(d, 16, itemsize)
    assert plan["per_split"] % pd.TILE == 0
    assert plan["splits"] * plan["per_split"] >= plan["span"]


# --------------------------------------------------------------- (c) engine
PRECISIONS = [(4, 8), (8, 4), (8, 8), (16, 16)]
STATS = ("tokens_out", "spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
         "prefix_hit_tokens", "mixed_precision_steps", "prefill_chunks")


def _traffic(i):
    """The smoke's f32 traffic: (w, kv) cycling over PRECISIONS, greedy on
    even requests and sampled on odd ones, spec_k 3 with a w4 draft on the
    second half."""
    w, kv = PRECISIONS[i % len(PRECISIONS)]
    samp = dict(max_new_tokens=6)
    if i % 2:
        samp.update(temperature=0.8, top_p=0.95, top_k=20 if i % 4 == 1 else 0, seed=i)
    prec = dict(w_bits=w, kv_bits=kv, spec_k=3 if i >= len(PRECISIONS) else 0, draft_bits=4)
    return samp, prec


def _serve(port, cfg, params):
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 512, 11)
    prompts = [np.concatenate([shared, rng.integers(0, 512, 3 + i)]).astype(np.int32)
               for i in range(8)]
    kw = dict(max_slots=4, page_size=4, prefill_chunk=8, num_pages=96, spec_k=3)
    if port:
        eng = ServeEngine(cfg, params, device="cpu", **kw)
        samp_cls, prec_cls = SamplingParams, PrecisionParams
    else:
        eng = JEngine(cfg, params, **kw)
        samp_cls, prec_cls = JSampling, JPrecision
    reqs = []
    for i, p in enumerate(prompts):
        samp, prec = _traffic(i)
        reqs.append(eng.submit(p, samp_cls(**samp), prec_cls(**prec)))
    eng.run()
    return [list(r.out_tokens) for r in reqs], {k: getattr(eng.stats, k) for k in STATS}


@pytest.fixture(scope="module")
def runs():
    """One JAX run and two port runs of the traffic, float32 throughout."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget("llama3.2-3b").reduced(), dtype="float32")
    params = jT.init_params(cfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return (_serve(False, cfg, params), _serve(True, tcfg, tparams),
            _serve(True, tcfg, tparams))


def test_f32_mixed_traffic_streams_match_jax(runs):
    (j_out, _), (t_out, _), _ = runs
    assert t_out == j_out
    assert all(len(o) == 6 for o in t_out)


def test_f32_mixed_traffic_counters_match_jax(runs):
    (_, j_stats), (_, t_stats), _ = runs
    assert t_stats == j_stats
    assert t_stats["spec_rounds"] > 0 and t_stats["prefix_hit_tokens"] > 0
    assert t_stats["mixed_precision_steps"] > 0


def test_f32_mixed_traffic_repeats_every_stream(runs):
    _, (t_out, t_stats), (again, again_stats) = runs
    assert again == t_out and again_stats == t_stats
    assert len({tuple(o) for o in t_out}) > 1
