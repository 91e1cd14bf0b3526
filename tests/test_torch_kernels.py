"""The port's plain kernel versions against the JAX package: the W4/W8
dequant matmul, paged decode and paged prefill, each against the JAX
``backend="xla"`` path and the Pallas kernel run in interpret mode (the way
tests/test_kernels_paged.py runs it on the CPU), and contiguous-cache decode
(``ops.mqa_decode``) against the Pallas kernel in interpret mode (the way
tests/test_kernels_decode.py runs it).  Inputs are numpy arrays
made from a seed and handed to both packages.  Tolerances are the
reference's own: 2e-3 for mpmm, 3e-3 for attention."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.kernels import ops as jops  # noqa: E402
from repro.quant.pack import pack_int4 as jpack_int4  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RNG = np.random.default_rng(0)
ATTN_TOL = dict(atol=3e-3, rtol=3e-3)
MPMM_TOL = dict(atol=2e-3, rtol=2e-3)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


# -------------------------------------------------------------------- mpmm
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("m,k,n", [(1, 128, 128), (5, 256, 96), (33, 384, 256)])
def test_mpmm_plain_matches_jax(w_bits, m, k, n):
    w = RNG.normal(size=(k, n)).astype(np.float32) / math.sqrt(k)
    x = RNG.normal(size=(m, k)).astype(np.float32)
    jd, js = jops.pack_weights(jnp.asarray(w), w_bits)
    wd, ws = np.asarray(jd), np.asarray(js)
    got = ops.mpmm(_t(x), _t(wd), _t(ws), w_bits=w_bits).numpy()
    assert np.array_equal(ref.mpmm_ref(_t(x), _t(wd), _t(ws), w_bits=w_bits).numpy(), got)
    for backend, interp in (("xla", None), ("pallas", True)):
        exp = jops.mpmm(_j(x), _j(wd), _j(ws), w_bits=w_bits, backend=backend,
                        interpret=interp)
        np.testing.assert_allclose(got, np.asarray(exp), **MPMM_TOL, err_msg=backend)


def test_mpmm_leading_dims_and_unported_modes():
    x = torch.from_numpy(RNG.normal(size=(2, 3, 64)).astype(np.float32))
    wd, ws = ops.pack_weights(torch.from_numpy(RNG.normal(size=(64, 32)).astype(np.float32)), 8)
    out = ops.mpmm(x, wd, ws, w_bits=8)
    assert out.shape == (2, 3, 32)
    np.testing.assert_array_equal(
        out.reshape(6, 32).numpy(), ref.mpmm_ref(x.reshape(6, 64), wd, ws, w_bits=8).numpy()
    )
    # the FF order, the selector and int mode, once unported, keep the
    # leading dims too; what no kernel takes still raises
    for kw in ({"dataflow": "ff"}, {"dataflow": "auto"}):
        got = ops.mpmm(x, wd, ws, w_bits=8, **kw)
        assert got.shape == (2, 3, 32)
        np.testing.assert_allclose(got.reshape(6, 32).numpy(),
                                   ref.mpmm_ref(x.reshape(6, 64), wd, ws, w_bits=8).numpy(),
                                   **MPMM_TOL)
    xi = torch.from_numpy(RNG.integers(-99, 99, (2, 3, 64)).astype(np.int16))
    got = ops.mpmm(xi, wd, ws, w_bits=8, mode="int")
    assert got.shape == (2, 3, 32)
    np.testing.assert_array_equal(
        got.reshape(6, 32).numpy(),
        (ref.mpmm_ref(xi.reshape(6, 64), wd, ws, w_bits=8, mode="int").float() * ws).numpy())
    for kw in ({"mode": "int8"}, {"dataflow": "kf"}, {"x_bits": 8}):
        with pytest.raises(ValueError):
            ops.mpmm(x, wd, ws, w_bits=8, **kw)


# ------------------------------------------------------------ paged inputs
def _payload(shape, kv_bits):
    """(payload as the pool stores it, per-token scales or None)."""
    if kv_bits == 16:
        return RNG.normal(size=shape).astype(np.float32), None
    lim = 8 if kv_bits == 4 else 128
    x = RNG.integers(-lim, lim, shape).astype(np.int8)
    s = (RNG.random((*shape[:-1], 1)) * 0.1).astype(np.float32)
    if kv_bits == 4:
        x = np.asarray(jpack_int4(jnp.asarray(x), axis=-1))
    return x, s


def _pool_case(kv_bits, n_layers, n_pages, ps, hkv, d):
    kp, ks = _payload((n_layers, n_pages, ps, hkv, d), kv_bits)
    vp, vs = _payload((n_layers, n_pages, ps, hkv, d), kv_bits)
    return kp, vp, ks, vs


# ------------------------------------------------------------- paged decode
@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("b,hkv,groups,d,ps,w", [(3, 2, 3, 32, 8, 4), (2, 1, 4, 64, 4, 5)])
def test_paged_decode_plain_matches_jax(kv_bits, window, b, hkv, groups, d, ps, w):
    n_layers, n_pages = 2, b * w + 2
    kp, vp, ks, vs = _pool_case(kv_bits, n_layers, n_pages, ps, hkv, d)
    nk, nks = _payload((b, hkv, d), kv_bits)
    nv, nvs = _payload((b, hkv, d), kv_bits)
    q = RNG.normal(size=(b, hkv * groups, d)).astype(np.float32)
    # distinct shuffled pages; the spare pages hold stale entries nobody owns
    tables = RNG.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)
    # empty row, mid-page row, full table: pages past each length are stale
    lengths = np.array([0, ps + 3, w * ps][:b], np.int32)
    args = (q, kp, vp, ks, vs, tables, lengths)
    for layer in (1,):  # a nonzero layer: the offset into the pool's layer dim
        got = ops.paged_mqa_decode(
            *map(_t, args), layer, _t(nk), _t(nv), _t(nks), _t(nvs),
            kv_bits=kv_bits, window=window,
        ).numpy()
        for backend, interp in (("xla", None), ("pallas", True)):
            exp = jops.paged_mqa_decode(
                *map(_j, args), layer, _j(nk), _j(nv), _j(nks), _j(nvs),
                kv_bits=kv_bits, window=window, backend=backend, interpret=interp,
            )
            np.testing.assert_allclose(got, np.asarray(exp), **ATTN_TOL,
                                       err_msg=f"{backend} layer={layer}")


def test_paged_decode_ignores_stale_entries_past_length():
    """Pool contents at or past a row's length never leak into its output:
    scribbling over them (including page 0, where zero-padded table slots
    point) leaves the result unchanged."""
    b, hkv, g, d, ps, w, kv_bits = 2, 2, 2, 32, 4, 4, 8
    kp, vp, ks, vs = _pool_case(kv_bits, 1, 9, ps, hkv, d)
    tables = np.array([[3, 5, 0, 0], [7, 1, 2, 0]], np.int32)
    lengths = np.array([6, 9], np.int32)
    nk, nks = _payload((b, hkv, d), kv_bits)
    q = _t(RNG.normal(size=(b, hkv * g, d)).astype(np.float32))

    def run(kp_):
        return ops.paged_mqa_decode(
            q, _t(kp_), _t(vp), _t(ks), _t(vs), _t(tables), _t(lengths), 0,
            _t(nk), _t(nk), _t(nks), _t(nks), kv_bits=kv_bits,
        )

    before = run(kp)
    dirty = kp.copy()
    dirty[0, 5, 2:] = 127  # row 0: positions 6, 7 of page 5 are past length 6
    dirty[0, 2, 1:] = -128  # row 1: positions 9.. of page 2
    dirty[0, 0] = 99  # page 0 backs every zero-padded slot
    np.testing.assert_array_equal(before.numpy(), run(dirty).numpy())


# ------------------------------------------------ launch plans of the kernels
# (M, K, N) the paths launch the CF kernel at: llama3.2-3b's projections at
# the engine's chunk (M 128) and at M 256, zamba2-7b's in_proj / out_proj at
# its prefill M (8 x 512), ResNet18's three CF layers at batch 8, and decode M
PLAN_SHAPES = (
    [(m, k, n) for m in (128, 256)
     for k, n in [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072), (3072, 128256)]]
    + [(4096, 3584, 14576), (4096, 7168, 3584)]
    + [(6272, 64, 128), (1568, 128, 256), (392, 256, 512)]
    + [(129, 96, 200), (300, 130, 1032), (8, 3072, 8192), (1, 8192, 3072)]
)


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_mpmm_launch_plan_covers_the_shape(m, k, n):
    """The tile / split chooser covers M, N and K exactly once; every split
    starts on a whole K step (even, so int4 splits start on a byte row); the
    tensor-core grid fills at least 90% of one wave of the H100's SMs or its
    K split is exhausted, and a split never takes it past two blocks per SM."""
    from repro_torch.kernels import mpmm as mp

    plan = mp.launch_plan(m, n, k, w_bits=4)
    gx, gy, gz = plan["grid"]
    splits, per = plan["splits"], plan["k_per_split"]
    assert (gx - 1) * plan["block_n"] < n <= gx * plan["block_n"]
    assert (splits - 1) * per < k <= splits * per
    assert plan["kernel"] == "tensor_core" and gz == splits
    if m <= 8:  # decode M: one 8-row tile, K split to two blocks per SM
        assert plan["block_m"] == mp.DECODE_M and gy == 1
        assert per % mp.DECODE_BK == 0
        assert gx * gz >= 0.9 * 2 * mp.SMS or splits == max(mp.even_splits(k, mp.DECODE_BK, 1))
        return
    bm = plan["block_m"]
    assert bm in mp.TC_BLOCK_M and (gy - 1) * bm < m <= gy * bm
    assert per % mp.TC_BK == 0 and per % 2 == 0
    assert per >= min(k, mp.TC_MIN_STEPS * mp.TC_BK)
    blocks = gx * gy * gz
    assert blocks >= 0.9 * mp.SMS or splits == max(mp.even_splits(k, mp.TC_BK, mp.TC_MIN_STEPS))
    assert splits == 1 or blocks <= 2 * mp.SMS
    assert mp.wave_fill(blocks) <= 1.0


def test_mpmm_launch_plan_at_the_serving_shapes():
    """The plans the numbers in PERF.md were measured with."""
    from repro_torch.kernels.mpmm import launch_plan

    assert launch_plan(4096, 14576, 3584)["grid"] == (114, 32, 1)
    assert launch_plan(4096, 3584, 7168)["grid"] == (28, 32, 1)
    assert launch_plan(256, 3072, 3072)["grid"] == (24, 2, 5)
    assert launch_plan(128, 1024, 3072)["grid"] == (8, 2, 8)
    assert launch_plan(392, 512, 256)["grid"] == (4, 7, 1)


@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("k,n", [(3072, 3072), (3072, 1024), (8192, 3072), (3072, 128256),
                                 (1100, 200), (96, 40), (4100, 8192)])
def test_mpmm_decode_plan_covers_k_in_whole_tiles(m, k, n, w_bits):
    """At M <= 8 every split starts on a whole 128-row K step (even, so an
    int4 split starts on a byte row), the splits cover K exactly once with
    the last one ragged or full, the plan does not depend on M, and the
    fewest splits within 90% of the best fill of two blocks per SM (int4)
    or one (int8) win; an M <= 8 plan without w_bits raises."""
    from repro_torch.kernels import mpmm as mp

    plan = mp.launch_plan(m, n, k, w_bits=w_bits)
    splits, per = plan["splits"], plan["k_per_split"]
    starts = [s * per for s in range(splits)]
    assert all(s % mp.DECODE_BK == 0 and (s // 2) * 2 == s for s in starts)
    assert starts[-1] < k <= starts[-1] + per
    assert plan == mp.launch_plan(8, n, k, w_bits=w_bits)
    with pytest.raises(ValueError, match="w_bits"):
        mp.launch_plan(m, n, k)
    opts = mp.even_splits(k, mp.DECODE_BK, 1)
    assert opts[splits] * mp.DECODE_BK == per
    per_sm = 2 if w_bits == 4 else 1
    fill = {s: mp.wave_fill(-(-n // mp.TC_BN) * s, per_sm=per_sm) for s in opts}
    assert fill[splits] >= 0.9 * max(fill.values())
    assert all(fill[s] < 0.9 * max(fill.values()) for s in fill if s < splits)


def _resnet18_int_shapes():
    """(M, K, N) of every ResNet18 conv as a matmul at batch 1 and 2, the
    batches the int mode is checked at."""
    from repro_torch.models.cnn_zoo import resnet18_layers

    shapes = set()
    for l in resnet18_layers():
        ho = (l.h + 2 * l.padding - l.k) // l.stride + 1
        wo = (l.w + 2 * l.padding - l.k) // l.stride + 1
        for b in (1, 2):
            shapes.add((b * ho * wo, l.cin * l.k * l.k, l.cout))
    return sorted(shapes)


@pytest.mark.parametrize("dataflow", ["cf", "ff"])
@pytest.mark.parametrize("m,k,n", _resnet18_int_shapes() + [(392, 2240, 256), (8, 1100, 64)])
def test_mpmm_int_launch_plan_covers_k_and_fills_the_card(m, k, n, dataflow):
    """The int kernel's plan: 64 x 64 output tiles; K ranges of stage_k rows
    cover K exactly once; FF's are the 512-row stages; CF's are whole 64-row
    K tiles when K is split (only from INT_SPLIT_MIN_K rows, at least two
    tiles each, never past two blocks per SM), and the split fills at least
    90% of the best fill any such split gives, with the fewest splits."""
    from repro_torch.kernels import mpmm as mp

    plan = mp.int_launch_plan(m, n, k, dataflow)
    stage_k, stages = plan["stage_k"], plan["stages"]
    gx, gy, gz = plan["grid"]
    assert (stages - 1) * stage_k < k <= stages * stage_k and gz == stages
    assert plan["block_m"] == plan["block_n"] == mp.INT_TILE == 64
    assert (gx - 1) * 64 < n <= gx * 64 and (gy - 1) * 64 < m <= gy * 64
    if dataflow == "ff":
        assert stage_k == 512
        return
    if k < mp.INT_SPLIT_MIN_K:
        assert stages == 1
        return
    if stages > 1:
        assert stage_k % mp.TC_BK == 0 and stage_k >= 2 * mp.TC_BK
        assert gx * gy * gz <= 2 * mp.SMS
    steps = -(-k // mp.TC_BK)
    fills = {}
    for per in range(2, steps + 1):
        s = -(-steps // per)
        if s == 1 or gx * gy * s <= 2 * mp.SMS:
            fills[s] = mp.wave_fill(gx * gy * s)
    best = max(fills.values())
    assert fills[stages] >= 0.9 * best
    assert all(f < 0.9 * best for s, f in fills.items() if s < stages)


def test_mpmm_int_launch_plan_at_resnet18():
    """The plans the int numbers in PERF.md were measured with."""
    from repro_torch.kernels.mpmm import int_launch_plan

    assert int_launch_plan(392, 256, 2304, "cf")["grid"] == (4, 7, 9)
    assert int_launch_plan(392, 256, 2304, "ff")["grid"] == (4, 7, 5)
    assert int_launch_plan(3136, 64, 576, "cf")["grid"] == (1, 49, 1)
    assert int_launch_plan(12544, 64, 147, "cf")["grid"] == (1, 196, 1)
    plan = int_launch_plan(392, 256, 2240, "cf")  # a short last split: 3 of 4 tiles
    assert plan["stages"] == 9 and 2240 - 8 * plan["stage_k"] == 192


# (M, K, N) the FF order runs at: ResNet18's FF layers at batch 8 (M = 8 Ho
# Wo), the serving-shaped case of chip_smoke.py, and small ragged shapes
FF_PLAN_SHAPES = [(100352, 147, 64), (25088, 576, 64), (6272, 576, 128), (6272, 1152, 128),
                  (1568, 1152, 256), (1568, 2304, 256), (392, 2304, 512), (392, 4608, 512),
                  (8, 3072, 8192), (1, 96, 40), (64, 100, 10), (65, 1100, 77)]


@pytest.mark.parametrize("m,k,n", FF_PLAN_SHAPES)
def test_mpmm_ff_launch_plan_splits_at_the_stages(m, k, n):
    """The FF order's plan: one split per 512-row K stage (the JAX kernel's
    bk), so each split's partial is a stage partial; the grid covers M and N
    exactly once with 128- or 64-row tiles, 128 unless 64 fills the card's
    block slots more than 1 / 0.9 times as well."""
    from repro_torch.kernels import mpmm as mp
    from repro_torch.kernels.ref import FF_STAGE_K

    plan = mp.launch_plan(m, n, k, stage_k=FF_STAGE_K)
    gx, gy, gz = plan["grid"]
    assert plan["kernel"] == "tensor_core" and plan["k_per_split"] == FF_STAGE_K == 512
    assert plan["splits"] == gz == -(-k // 512)
    assert (gx - 1) * plan["block_n"] < n <= gx * plan["block_n"]
    bm = plan["block_m"]
    assert bm in mp.TC_BLOCK_M and (gy - 1) * bm < m <= gy * bm
    fill = {b: mp.wave_fill(-(-m // b) * gx * gz) for b in mp.TC_BLOCK_M}
    if m <= 64:
        assert bm == 64
    else:
        assert (bm == 128) == (fill[128] >= 0.9 * max(fill.values()))


@pytest.mark.parametrize("b,hkv,g,s", [(8, 32, 1, 552), (8, 32, 1, 545), (1, 32, 1, 32768),
                                       (8, 8, 3, 1024), (3, 8, 3, 1000), (2, 4, 1, 70),
                                       (1, 1, 8, 5), (2, 2, 5, 300), (64, 32, 1, 552)])
def test_mqa_decode_plan_covers_the_positions(b, hkv, g, s):
    """The decode kernel's split: whole 8-token tiles, the splits covering S
    exactly once, at least MIN_SPLIT positions each (or one split), a grid
    of blocks of up to 4 kv heads (a warp each) within TARGET_BLOCKS blocks
    of 4 warps unless one split alone passes it, and query groups of at
    most 4."""
    from repro_torch.kernels import mqa_decode as md

    plan = md.decode_plan(b, hkv, g, s)
    splits, per, groups = plan["splits"], plan["per_split"], plan["groups"]
    head_blocks = -(-hkv // md.BLOCK_HEADS)
    assert plan["grid"] == (b, head_blocks * groups, splits)
    assert per % md.SPLIT_UNIT == 0 and (splits - 1) * per < s <= splits * per
    assert splits == 1 or per >= md.MIN_SPLIT
    assert (groups - 1) * md.GROUP_QUERIES < g <= groups * md.GROUP_QUERIES
    warps = b * head_blocks * groups * splits * min(hkv, md.BLOCK_HEADS)
    assert splits == 1 or warps <= md.TARGET_BLOCKS * md.BLOCK_HEADS


@pytest.mark.parametrize("b,hkv,g,s,d", [(8, 1, 8, 32768, 256), (4, 1, 8, 32768, 256),
                                         (8, 1, 4, 2048, 256), (3, 2, 5, 300, 192),
                                         (1, 1, 1, 5, 256), (8, 8, 3, 1024, 128)])
def test_mqa_decode_plan_groups_by_head_dim(b, hkv, g, s, d):
    """Head dims past 128 take the wide instantiation, at most 2 queries a
    block (4 at D <= 128); the split still covers S in whole tiles, and a
    head dim past 256 is refused."""
    from repro_torch.kernels import mqa_decode as md

    plan = md.decode_plan(b, hkv, g, s, d)
    gq = md.GROUP_QUERIES_WIDE if d > md.NARROW_HEAD_DIM else md.GROUP_QUERIES
    groups, splits, per = plan["groups"], plan["splits"], plan["per_split"]
    assert md.group_queries(d) == gq and (groups - 1) * gq < g <= groups * gq
    assert plan["grid"] == (b, -(-hkv // md.BLOCK_HEADS) * groups, splits)
    assert per % md.SPLIT_UNIT == 0 and (splits - 1) * per < s <= splits * per
    warps = b * plan["grid"][1] * splits * min(hkv, md.BLOCK_HEADS)
    assert splits == 1 or warps <= md.TARGET_BLOCKS * md.BLOCK_HEADS
    with pytest.raises(ValueError, match="head dims up to 256"):
        md.decode_plan(b, hkv, g, s, 264)


def test_mqa_decode_plan_fills_the_card_at_zamba2():
    """zamba2-7b's serving shape (8 rows x 32 kv heads of 545-552 positions)
    and its 32k context (32 pairs) both give at least three blocks per SM."""
    from repro_torch.kernels import mqa_decode as md
    from repro_torch.kernels.mpmm import SMS

    for b, s in ((8, 552), (1, 32768)):
        gx, gy, gz = md.decode_plan(b, 32, 1, s)["grid"]
        assert gx * gy * gz >= 3 * SMS
    assert md.decode_plan(8, 32, 1, 552)["splits"] == 8
    assert md.decode_plan(1, 32, 1, 32768)["splits"] == 66


# (B, Hkv, G, D, W, ps, window): llama3.2-3b serving (65 pages of 16) with
# and without a window, yi-9b's heads, gemma3-1b's (1 x 4 x 256, window
# 1024), the reduced configs' heads with a short window, 12 queries a kv head
# at ps 4, a one-page table, and many rows
PAGED_PLAN_SHAPES = [
    (8, 8, 3, 128, 65, 16, None), (8, 8, 3, 128, 65, 16, 256), (8, 4, 8, 128, 65, 16, None),
    (8, 1, 4, 256, 129, 16, 1024), (3, 2, 2, 32, 4, 8, 7), (1, 1, 12, 64, 3, 4, None),
    (2, 2, 3, 64, 1, 16, None), (64, 8, 3, 128, 200, 16, None),
]


@pytest.mark.parametrize("b,hkv,g,d,w,ps,window", PAGED_PLAN_SHAPES)
def test_paged_decode_plan_covers_every_position_in_whole_tiles(b, hkv, g, d, w, ps, window):
    """Splits of whole 8-token tiles that cover the span a row can reach (the
    table's capacity, or the window where smaller) once, at least MIN_SPLIT
    positions each unless there is one, at most MAX_SPLITS; query groups a
    warp's registers hold; every live position of every length (from the
    row's window start) falls in a planned split."""
    from repro_torch.kernels import paged_decode as pd

    plan = pd.decode_plan(b, hkv, g, d, w, ps, window)
    cap = w * ps
    span, per, splits = plan["span"], plan["per_split"], plan["splits"]
    assert span == (cap if window is None else min(cap, window))
    assert per % pd.TILE == 0 and (splits - 1) * per < span <= splits * per
    assert 1 <= splits <= pd.MAX_SPLITS and (splits == 1 or per >= pd.MIN_SPLIT)
    groups, gq = plan["groups"], plan["group_queries"]
    assert (groups - 1) * gq < g <= groups * gq and gq <= pd.GROUP_QUERIES
    assert plan["grid"] == (b, -(-hkv * groups * splits // pd.BLOCK_WARPS))
    for length in range(cap + 1):
        lo = max(length + 1 - window, 0) if window else 0
        if length > lo:
            assert (length - 1 - lo) // per < splits


def test_paged_decode_plan_window_caps_the_span():
    """A window of 256 over a 1040-position table plans over 256 positions:
    no split lies wholly past the window (the first version planned 9 splits
    of 128 there, most of them empty)."""
    from repro_torch.kernels import paged_decode as pd

    full = pd.decode_plan(8, 8, 3, 128, 65, 16)
    windowed = pd.decode_plan(8, 8, 3, 128, 65, 16, 256)
    assert windowed["span"] == 256 and full["span"] == 1040
    assert (windowed["splits"] - 1) * windowed["per_split"] < 256
    assert windowed["splits"] < full["splits"]
    # a window wider than the table changes nothing
    assert pd.decode_plan(8, 8, 3, 128, 65, 16, 4096) == full


def test_paged_decode_plan_fills_the_card_at_llama():
    """llama3.2-3b's serving shape (8 rows x 8 kv heads x 3 queries, ctx
    1024 in a 65-page table) keeps at least three 4-warp blocks per SM busy
    with live positions, in one wave of at most TARGET_WARPS warps."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels.mpmm import SMS

    plan = pd.decode_plan(8, 8, 3, 128, 65, 16)
    live_splits = -(-1024 // plan["per_split"])
    warps = 8 * 8 * plan["groups"] * live_splits
    assert 3 * SMS * pd.BLOCK_WARPS <= warps <= pd.TARGET_WARPS


def test_paged_decode_plan_refuses_wide_heads():
    """Head dims up to 256 fit the kernel's registers; wider ones raise
    before any launch."""
    from repro_torch.kernels import paged_decode as pd

    assert pd.decode_plan(8, 1, 4, 256, 129, 16, 1024)["groups"] == 1
    with pytest.raises(ValueError, match="head dims up to 256"):
        pd.decode_plan(8, 1, 4, 264, 129, 16)


def test_paged_decode_plan_takes_no_tensor():
    """The plan comes from shapes alone, so the wrapper never reads lengths
    back to the host (a decode step stays capturable as a CUDA graph)."""
    import inspect

    from repro_torch.kernels import paged_decode as pd

    params = inspect.signature(pd.decode_plan).parameters
    assert list(params) == ["b", "hkv", "g", "d", "w", "ps", "window", "kv_bits", "itemsize"]
    plan = pd.decode_plan(8, 8, 3, 128, 65, 16, 256)
    assert all(isinstance(v, int) for k, v in plan.items() if k != "grid")
    src = inspect.getsource(pd.paged_mqa_decode_cuda)
    for read_back in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(lengths"):
        assert read_back not in src


@pytest.mark.parametrize("c,g", [(1, 3), (5, 3), (32, 3), (128, 3), (128, 8), (21, 1),
                                 (64, 1), (65, 1)])
def test_paged_prefill_grid_covers_rows(c, g):
    from repro_torch.kernels.paged_prefill import ROWS_PER_BLOCK, launch_grid

    b, hkv, tiles = launch_grid(4, 8, c, g)
    assert (b, hkv) == (4, 8)
    assert (tiles - 1) * ROWS_PER_BLOCK < c * g <= tiles * ROWS_PER_BLOCK


def test_paged_prefill_head_dim_padding():
    from repro_torch.kernels.paged_prefill import padded_head_dim

    for d in range(2, 257, 2):
        dp = padded_head_dim(d)
        assert dp % 16 == 0 and d <= dp and (dp == 32 or dp // 2 < d)
    assert padded_head_dim(192) == 256 and padded_head_dim(256) == 256
    with pytest.raises(ValueError, match="head dims up to 256"):
        padded_head_dim(258)


# ------------------------------------------------------------ paged prefill
@pytest.mark.parametrize("kv_bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("c", [1, 5, 8])
def test_paged_prefill_plain_matches_jax(kv_bits, window, c):
    b, hkv, groups, d, ps, w, n_layers = 3, 2, 2, 32, 4, 5, 2
    n_pages = b * w + 1
    kp, vp, ks, vs = _pool_case(kv_bits, n_layers, n_pages, ps, hkv, d)
    ck, cks = _payload((b, c, hkv, d), kv_bits)
    cv, cvs = _payload((b, c, hkv, d), kv_bits)
    q = RNG.normal(size=(b, c, hkv * groups, d)).astype(np.float32)
    tables = RNG.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)
    ctx = np.array([0, 6, 11], np.int32)
    q_lens = np.array([c, max(c - 2, 1), (c + 1) // 2], np.int32)  # ragged
    args = (q, kp, vp, ks, vs, tables, ctx, q_lens)
    for layer in (1,):  # a nonzero layer: the offset into the pool's layer dim
        got = ops.paged_mqa_prefill(
            *map(_t, args), layer, _t(ck), _t(cv), _t(cks), _t(cvs),
            kv_bits=kv_bits, window=window,
        ).numpy()
        assert np.isfinite(got).all()  # padding rows too
        valid = np.arange(c)[None, :] < q_lens[:, None]  # padding rows: unspecified
        for backend, interp in (("xla", None), ("pallas", True)):
            exp = np.asarray(jops.paged_mqa_prefill(
                *map(_j, args), layer, _j(ck), _j(cv), _j(cks), _j(cvs),
                kv_bits=kv_bits, window=window, backend=backend, interpret=interp,
            ))
            np.testing.assert_allclose(got[valid], exp[valid], **ATTN_TOL,
                                       err_msg=f"{backend} layer={layer}")


# -------------------------------------------------- contiguous-cache decode
@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("lengths", [[5, 1], [300, 173]])
def test_mqa_decode_plain_matches_jax(kv_bits, groups, lengths):
    """S = 300 is not a multiple of the Pallas block (bs = 128: padded and
    masked there); short and ragged lengths; int4 packed along D."""
    b, s, hkv, d = 2, 300, 2, 32
    q = RNG.normal(size=(b, hkv * groups, d)).astype(np.float32)
    kd, ks = jops.quantize_kv(jnp.asarray(RNG.normal(size=(b, s, hkv, d)), jnp.float32), kv_bits)
    vd, vs = jops.quantize_kv(jnp.asarray(RNG.normal(size=(b, s, hkv, d)), jnp.float32), kv_bits)
    lens = np.array(lengths, np.int32)
    exp = jops.mqa_decode(jnp.asarray(q), kd, vd, ks, vs, jnp.asarray(lens), kv_bits=kv_bits,
                          bs=128, interpret=True)
    got = ops.mqa_decode(*map(_t, (q, kd, vd, ks, vs, lens)), kv_bits=kv_bits)
    assert got.shape == (b, hkv * groups, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **ATTN_TOL)
    # cache entries at or past a row's length never reach the output
    kd2 = np.array(kd)
    kd2[0, lens[0]:] = 127
    kd2[1, lens[1]:] = -128
    again = ops.mqa_decode(*map(_t, (q, kd2, vd, ks, vs, lens)), kv_bits=kv_bits)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_mqa_decode_rejects_other_kv_bits():
    q = torch.zeros(1, 2, 8)
    kv = torch.zeros(1, 4, 2, 8, dtype=torch.int8)
    sc = torch.ones(1, 4, 2, 1)
    for bits in (16, 2):
        with pytest.raises(ValueError, match="kv_bits"):
            ops.mqa_decode(q, kv, kv, sc, sc, torch.tensor([1], dtype=torch.int32),
                           kv_bits=bits)


def test_gather_pages_layout():
    pool = torch.arange(2 * 5 * 3).reshape(2, 5, 3)
    tables = torch.tensor([[4, 0], [1, 2]], dtype=torch.int32)
    g = ref.gather_pages(pool, tables)
    assert g.shape == (2, 2, 6)
    assert g[1, 0].tolist() == pool[1, 4].tolist() + pool[1, 0].tolist()
