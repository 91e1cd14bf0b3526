"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``).

They keep the JAX package's layouts at the public functions and handle what
the raw kernels do not: weight packing and quantization, KV quantization,
the query regrouping for GQA, FF/CF dataflow selection (the cycle model's
selector, as in the JAX package), patch extraction for convolutions, and
device dispatch.  Dispatch rule: a tensor
on the CPU goes to the kernel's plain version (``kernels/ref.py``); a CUDA
tensor launches the hand-written kernel, or raises.  There is no fallback
from one to the other.  The two kernels of the dry run's path, the CF
dequant matmul and ``mqa_decode``, are torch operators of their own
(``torch.ops.repro_torch.mpmm`` and ``.mqa_decode``) with a third rule: a
meta tensor (the dry run, ``launch/dryrun.py``) gets the kernel's contract,
the CUDA wrapper's checks and allocations with nothing computed or
launched.  Each of the two has a FLOP formula in
``torch.utils.flop_counter``'s registry, so a dispatch mode (a FLOP count,
``launch/cost_analysis.py``) sees one call as one op, with the kernel's
FLOPs and its inputs and outputs, on every device.  The sampling ops at the
end are plain torch ops on either device, as the JAX package's are XLA code.
"""
from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.dataflow import ConvLayer
from repro_torch.core.isa import Dataflow
from repro_torch.core.perfmodel import select_dataflow
from repro_torch.core.precision import Precision
from repro_torch.kernels import mpmm as mpmm_mod
from repro_torch.kernels import mqa_decode as mqa_mod
from repro_torch.kernels import paged_decode as decode_mod
from repro_torch.kernels import paged_prefill as prefill_mod
from repro_torch.kernels import prng
from repro_torch.kernels import ref as ref_mod
from repro_torch.quant.pack import pack_int4, unpack_int4

__all__ = [
    "pack_weights",
    "quantize_kv",
    "mpmm",
    "select_matmul_dataflow",
    "mpconv",
    "conv_pack_weights",
    "mqa_decode",
    "paged_mqa_decode",
    "paged_mqa_prefill",
    "paged_mqa_verify",
    "sample_keys",
    "sampling_probs",
    "sample_from_probs",
    "sample_tokens",
    "sample_or_argmax",
]

_INT_DTYPE = {4: torch.int8, 8: torch.int8, 16: torch.int16}


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain
    version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


# The operators of the dry run's kernels: one implementation per device.
NAMESPACE = "repro_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define("mpmm(Tensor x, Tensor w_data, Tensor w_scale, int w_bits, "
            "ScalarType out_dtype) -> Tensor")
_LIB.define("mqa_decode(Tensor q, Tensor k_data, Tensor v_data, Tensor k_scale, "
            "Tensor v_scale, Tensor lengths, int kv_bits, float sm_scale) -> Tensor")


def _mpmm_on(fn):
    return lambda x, w_data, w_scale, w_bits, out_dtype: fn(
        x, w_data, w_scale, w_bits=w_bits, out_dtype=out_dtype)


def _mqa_on(fn):
    return lambda q, k_data, v_data, k_scale, v_scale, lengths, kv_bits, sm_scale: fn(
        q, k_data, v_data, k_scale, v_scale, lengths, kv_bits=kv_bits, sm_scale=sm_scale)


def _mqa_decode_plain(q, k_data, v_data, k_scale, v_scale, lengths, *, kv_bits, sm_scale):
    """The plain version on the kernel's layout (q [B, Hkv, G, D])."""
    b, hkv, g, d = q.shape
    if kv_bits == 4:
        k_data, v_data = unpack_int4(k_data, dim=-1), unpack_int4(v_data, dim=-1)
    out = ref_mod.mqa_decode_ref(q.reshape(b, hkv * g, d), k_data, v_data, k_scale, v_scale,
                                 lengths, sm_scale=sm_scale)
    return out.reshape(b, hkv, g, d)


for _key, _mpmm_fn, _mqa_fn in (
    ("CPU", ref_mod.mpmm_ref, _mqa_decode_plain),
    ("CUDA", mpmm_mod.mpmm_cuda, mqa_mod.mqa_decode_cuda),
    ("Meta", mpmm_mod.mpmm_contract, mqa_mod.mqa_decode_contract),
):
    _LIB.impl("mpmm", _mpmm_on(_mpmm_fn), _key)
    _LIB.impl("mqa_decode", _mqa_on(_mqa_fn), _key)


@register_flop_formula(torch.ops.repro_torch.mpmm)
def _mpmm_flops(x_shape, w_shape, s_shape, w_bits, out_dtype, out_shape=None, **kwargs):
    return mpmm_mod.mpmm_cost(x_shape[0], x_shape[1], w_shape[-1], 0)[0]


@register_flop_formula(torch.ops.repro_torch.mqa_decode)
def _mqa_decode_flops(q_shape, k_shape, *args, out_shape=None, **kwargs):
    b, hkv, g, d = q_shape
    kv_bits = args[4]
    return mqa_mod.decode_cost(b, hkv, g, d, b * k_shape[1], kv_bits)[0]


def pack_weights(w: torch.Tensor, bits: int,
                 amax_reduce=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric quantization of a [..., K, N] weight.

    Returns (w_data, w_scale): w_data is [..., K, N] int8/int16, or
    [..., K//2, N] int8 with two K-consecutive nibbles per byte when
    bits == 4; w_scale is [..., 1, N] f32.  Leading dims quantize
    independently (the JAX package vmaps over stacked layers).
    ``amax_reduce(amax)``, where ``w`` is one rank's block of a weight split
    along K, turns the block's column maxima [..., 1, N] into the whole
    weight's (``sharding.dim_all_max``), so the block quantizes as its
    rows of the whole weight do.
    """
    prec = Precision.from_bits(bits)
    amax = w.abs().amax(dim=-2, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    amax = torch.clamp_min(amax, 1e-30)
    scale = (amax / prec.spec.qmax).to(torch.float32)
    q = torch.clamp(torch.round(w / scale), prec.spec.qmin, prec.spec.qmax)
    q = q.to(_INT_DTYPE[bits])
    if bits == 4:
        q = pack_int4(q, dim=-2)
    return q, scale


def quantize_kv(kv: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, S, Hkv, D] float -> (int8 payload [B, S, Hkv, D or D//2], scale
    [B, S, Hkv, 1] f32): per-(token, head) symmetric scales.  As in the JAX
    version the max and its division by qmax run in ``kv``'s dtype."""
    prec = Precision.from_bits(bits)
    amax = torch.clamp_min(kv.abs().amax(dim=-1, keepdim=True), 1e-30)
    scale = (amax / prec.spec.qmax).to(torch.float32)
    q = torch.clamp(torch.round(kv / scale), prec.spec.qmin, prec.spec.qmax)
    q = q.to(torch.int8)
    if bits == 4:
        q = pack_int4(q, dim=-1)
    return q, scale


def select_matmul_dataflow(m: int, n: int, k: int) -> Dataflow:
    """FF/CF selection for a matmul via the conv cost model (1x1 conv with
    cin=k, cout=n, h*w=m), as the JAX package does it."""
    hw = int(math.sqrt(max(m, 1))) or 1
    layer = ConvLayer("mm", cin=k, cout=n, k=1, h=hw, w=max(m // hw, 1))
    return select_dataflow(layer, Precision.INT8)


def mpmm(
    x: torch.Tensor,
    w_data: torch.Tensor,
    w_scale: torch.Tensor,
    *,
    w_bits: int,
    x_bits: int = 16,
    mode: str = "dequant",
    dataflow: str = "cf",
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Multi-precision matmul: x [..., K] @ dequant(w) -> [..., N].

    dequant mode returns x.dtype: CF fuses the scale on the f32 sum
    (``out_dtype=torch.float32``: that scaled sum uncast, CF only); FF sums
    512-row K stages into an f32 accumulator, then the scale is applied in
    f32 and the result cast once.  On the card (and in the meta contract)
    the activations are bf16 or f32, each with its own kernel; any other
    type raises.  int mode (x int8/int16) returns f32 = int32 product (exact
    mod 2^32) * w_scale.  ``dataflow="auto"`` asks the cycle model's
    selector."""
    if mode not in ("int", "dequant"):
        raise ValueError(f"mode must be 'int' or 'dequant', got {mode!r}")
    if dataflow not in ("ff", "cf", "auto"):
        raise ValueError(f"dataflow must be 'ff', 'cf' or 'auto', got {dataflow!r}")
    if mode == "dequant" and w_bits == 16:
        raise ValueError("w16 requires int mode (bf16 cannot hold int16 exactly)")
    lead = x.shape[:-1]
    k, n = x.shape[-1], w_data.shape[-1]
    x2 = x.reshape(-1, k)
    if dataflow == "auto":
        ff = select_matmul_dataflow(x2.shape[0], n, k) is Dataflow.FF
        dataflow = "ff" if ff else "cf"
    if mode == "int":
        card = on_card(x2)
        if x2.dtype not in (torch.int8, torch.int16):
            raise TypeError(f"int mode takes int8 or int16 activations, got {x2.dtype}")
        if x_bits <= 8 and x2.dtype == torch.int16:
            raise ValueError(f"x_bits={x_bits} takes int8 activations, got int16")
        if w_data.dtype != _INT_DTYPE.get(w_bits):
            raise TypeError(f"w{w_bits} int mode takes {_INT_DTYPE.get(w_bits)} weights, "
                            f"got {w_data.dtype}")
        if card:
            acc = mpmm_mod.mpmm_int_cuda(x2.contiguous(), w_data, w_bits=w_bits,
                                         dataflow=dataflow)
        else:
            acc = ref_mod.mpmm_ref(x2, w_data, w_scale, w_bits=w_bits, mode="int")
        return (acc.float() * w_scale.float()).reshape(*lead, n)
    if x_bits != 16:
        raise ValueError(f"dequant mode takes 16-bit activations, got x_bits={x_bits}")
    if x2.device.type != "cpu" and x2.dtype not in mpmm_mod.X32_DTYPES:
        raise ValueError(f"the dequant kernels take bf16 activations or float32 ones on the "
                         f"card (and in their contract), got {x2.dtype}")
    if out_dtype not in (None, x.dtype) and (dataflow != "cf" or out_dtype != torch.float32):
        raise ValueError(f"dequant mode writes x.dtype, or f32 in the CF order; got "
                         f"out_dtype={out_dtype} with dataflow={dataflow!r}")
    if dataflow == "cf":
        out = torch.ops.repro_torch.mpmm(x2.contiguous(), w_data, w_scale, w_bits,
                                         out_dtype or x.dtype)
    else:
        if on_card(x2):
            acc = mpmm_mod.mpmm_ff_cuda(x2.contiguous(), w_data, w_bits=w_bits)
        else:
            acc = ref_mod.mpmm_ff_ref(x2, w_data, w_bits=w_bits)
        out = (acc * w_scale.float()).to(x.dtype)
    return out.reshape(*lead, n)


def mpconv(
    x: torch.Tensor,  # [N, H, W, Cin]
    w_data: torch.Tensor,  # packed [K*K*Cin (/2), Cout]
    w_scale: torch.Tensor,  # [1, Cout]
    *,
    w_bits: int,
    ksize: int,
    stride: int = 1,
    padding: int = 0,
    mode: str = "dequant",
    dataflow: str = "auto",
) -> torch.Tensor:
    """Multi-precision convolution = patch extraction + the mpmm kernels.

    The FF/CF choice is the contraction loop order of the matmul core; with
    ``dataflow="auto"`` the selector receives the true conv geometry at
    ``w_bits`` precision, as in the JAX package."""
    n, h, w, cin = x.shape
    cout = w_data.shape[-1]
    if dataflow == "auto":
        layer = ConvLayer("conv", cin=cin, cout=cout, k=ksize, h=h, w=w,
                          stride=stride, padding=padding)
        ff = select_dataflow(layer, Precision.from_bits(w_bits)) is Dataflow.FF
        dataflow = "ff" if ff else "cf"
    patches = ref_mod.conv_patches(x, ksize, stride, padding)
    ho, wo = patches.shape[1], patches.shape[2]
    out = mpmm(patches.reshape(-1, patches.shape[-1]), w_data, w_scale, w_bits=w_bits,
               x_bits=16, mode=mode, dataflow=dataflow)
    return out.reshape(n, ho, wo, cout)


def conv_pack_weights(w: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[Kh, Kw, Cin, Cout] float -> packed ([Cin*Kh*Kw (/2), Cout], [1, Cout])
    in the (cin, kh, kw) feature order of the patches."""
    kh, kw, cin, cout = w.shape
    return pack_weights(w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout), bits)


def mqa_decode(
    q: torch.Tensor,  # [B, H, D]
    k_data: torch.Tensor,  # [B, S, Hkv, D (/2 if kv_bits==4)] int8
    v_data: torch.Tensor,
    k_scale: torch.Tensor,  # [B, S, Hkv, 1] f32
    v_scale: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32 — valid cache length per row
    *,
    kv_bits: int = 8,
) -> torch.Tensor:
    """Single-token GQA attention against a contiguous int8/int4 KV cache.

    Query head h = kv * G + g of ``q [B, H, D]`` is regrouped to
    ``[B, Hkv, G, D]`` for the kernel; ``sm_scale = 1/sqrt(D)``.  On the CPU
    int4 payloads are unpacked for the plain version."""
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    b, h, d = q.shape
    hkv = k_data.shape[2]
    out = torch.ops.repro_torch.mqa_decode(
        q.reshape(b, hkv, h // hkv, d).contiguous(), k_data.contiguous(),
        v_data.contiguous(), k_scale.contiguous(), v_scale.contiguous(),
        lengths.to(torch.int32).contiguous(), kv_bits, 1.0 / math.sqrt(d))
    return out.reshape(b, h, d)


def paged_mqa_decode(
    q: torch.Tensor,  # [B, H, D]
    k_pool: torch.Tensor,  # [L, P, ps, Hkv, D (/2 if kv_bits==4)]
    v_pool: torch.Tensor,
    k_scale,  # [L, P, ps, Hkv, 1] f32, or None when kv_bits == 16
    v_scale,
    tables: torch.Tensor,  # [B, W] int32 page tables (zero-padded)
    lengths: torch.Tensor,  # [B] int32 — tokens already in the cache
    layer: int,  # pool layer to attend against
    new_k: torch.Tensor,  # [B, Hkv, D (/2)] this step's token, not yet stored
    new_v: torch.Tensor,
    new_k_scale=None,  # [B, Hkv, 1] f32, or None
    new_v_scale=None,
    *,
    kv_bits: int = 8,
    window=None,
) -> torch.Tensor:
    """Single-token GQA attention straight against the paged KV pool.

    Query head h = kv * G + g of ``q [B, H, D]`` is regrouped to
    ``[B, Hkv, G, D]`` for the kernel; ``sm_scale = 1/sqrt(D)``."""
    b, h, d = q.shape
    hkv = k_pool.shape[3]
    sm_scale = 1.0 / math.sqrt(d)
    if not on_card(q):
        return ref_mod.paged_mqa_decode_ref(
            q, k_pool, v_pool, k_scale, v_scale, tables, lengths, layer,
            new_k, new_v, new_k_scale, new_v_scale,
            sm_scale=sm_scale, kv_bits=kv_bits, window=window,
        )
    qg = q.reshape(b, hkv, h // hkv, d).contiguous()
    out = decode_mod.paged_mqa_decode_cuda(
        qg, k_pool, v_pool, k_scale, v_scale, tables, lengths, layer,
        new_k.contiguous(), new_v.contiguous(),
        None if new_k_scale is None else new_k_scale.contiguous(),
        None if new_v_scale is None else new_v_scale.contiguous(),
        kv_bits=kv_bits, sm_scale=sm_scale, window=window,
    )
    return out.reshape(b, h, d)


def paged_mqa_prefill(
    q: torch.Tensor,  # [B, C, H, D] — a chunk of C query tokens per row
    k_pool: torch.Tensor,  # [L, P, ps, Hkv, D (/2 if kv_bits==4)]
    v_pool: torch.Tensor,
    k_scale,  # [L, P, ps, Hkv, 1] f32, or None when kv_bits == 16
    v_scale,
    tables: torch.Tensor,  # [B, W] int32 page tables (zero-padded)
    ctx_lens: torch.Tensor,  # [B] int32 — tokens already in the pool
    q_lens: torch.Tensor,  # [B] int32 — valid chunk tokens per row
    layer: int,  # pool layer to attend against
    chunk_k: torch.Tensor,  # [B, C, Hkv, D (/2)] this chunk's K, not yet stored
    chunk_v: torch.Tensor,
    chunk_k_scale=None,  # [B, C, Hkv, 1] f32, or None
    chunk_v_scale=None,
    *,
    kv_bits: int = 8,
    window=None,
) -> torch.Tensor:
    """Chunked-prefill GQA attention straight against the paged KV pool.

    For the kernel ``q [B, C, H, D]`` becomes ``[B, Hkv, C, G, D]`` and the
    chunk K/V ``[B, Hkv, C, Dk]``, as in the JAX wrapper; the output comes
    back as [B, C, H, D]."""
    b, c, h, d = q.shape
    hkv = k_pool.shape[3]
    sm_scale = 1.0 / math.sqrt(d)
    if not on_card(q):
        return ref_mod.paged_mqa_prefill_ref(
            q, k_pool, v_pool, k_scale, v_scale, tables, ctx_lens, q_lens, layer,
            chunk_k, chunk_v, chunk_k_scale, chunk_v_scale,
            sm_scale=sm_scale, kv_bits=kv_bits, window=window,
        )
    qg = q.reshape(b, c, hkv, h // hkv, d).permute(0, 2, 1, 3, 4).contiguous()

    def t(x):
        return None if x is None else x.transpose(1, 2).contiguous()

    out = prefill_mod.paged_mqa_prefill_cuda(
        qg, k_pool, v_pool, k_scale, v_scale, tables, ctx_lens, q_lens, layer,
        t(chunk_k), t(chunk_v), t(chunk_k_scale), t(chunk_v_scale),
        kv_bits=kv_bits, sm_scale=sm_scale, window=window,
    )
    return out.permute(0, 2, 1, 3, 4).reshape(b, c, h, d)


def paged_mqa_verify(*args, **kwargs) -> torch.Tensor:
    """Multi-token verify attention of speculative decoding.  A verify
    window (the last emitted token and the drafts) *is* a causal self-chunk
    at positions ``ctx_lens[b] + c``, so this is :func:`paged_mqa_prefill`,
    the paged prefill kernel on the card, under the verify name."""
    return paged_mqa_prefill(*args, **kwargs)


# --------------------------------------------------------------- sampling ops
# Seeded stochastic sampling of the serving engine (port of the JAX
# package's sampling ops).  Every op is row-batched: each row carries its own
# temperature, top_k, top_p and key.  Keys are
# fold_in(fold_in(PRNGKey(seed), position), salt) through the port's own
# threefry (kernels/prng.py), bit-equal to jax.random's, so the token at
# stream position p depends only on (seed, p).  Greedy rows
# (temperature <= 0) are the exact raw argmax.  These are plain torch ops on
# either device; no hand-written kernel backs them (nor a Pallas one in JAX).


def sample_keys(seeds: torch.Tensor, positions: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """[B] seeds + [B] stream positions -> [B, 2] int64 keys (32-bit words).

    ``salt`` separates the independent draws one position needs
    (serve/spec_decode.py: draft, accept, resample)."""
    key = prng.prng_key(seeds)
    return prng.fold_in(prng.fold_in(key, positions), salt)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with ``torch.sum``'s cascaded sum: the CPU
    ``torch.softmax`` sums a 128k vocabulary in 16 sequential lanes and
    lands ~1e-5 (relative) off, where XLA's sum is within 1e-8."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _top_kp_mask(logits: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """[B, V] keep-mask: top-k by logit rank, then nucleus top-p on the
    renormalized survivors (HF warper order); top_k <= 0 and top_p >= 1
    disable their stage.  One descending sort drives both stages.  JAX sorts
    ascending (stable) and reverses, so equal logits come out highest index
    first: the same order here, not ``descending=True``'s."""
    b, v = logits.shape
    k = torch.clamp(torch.where(top_k > 0, top_k, v), 1, v)
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    sl = torch.gather(logits, 1, order)
    ranks = torch.arange(v, device=logits.device)[None, :]
    keep_k = ranks < k[:, None]
    probs = _softmax(torch.where(keep_k, sl, -torch.inf))
    cum = torch.cumsum(probs, dim=-1)
    # top_p >= 1 keeps everything explicitly: f32 tail mass can round
    # cum - probs up to exactly 1.0
    keep_p = ((cum - probs) < top_p[:, None]) | (top_p[:, None] >= 1.0)
    keep = keep_k & keep_p
    return torch.zeros_like(keep).scatter(1, order, keep)


def _masked_logits(logits, top_k, top_p):
    """The top-k/top-p mask applied; ``top_k=None`` / ``top_p=None`` skip
    their stage, and with both None the vocabulary is never sorted."""
    if top_k is None and top_p is None:
        return logits
    b = logits.shape[0]
    if top_k is None:
        top_k = torch.zeros(b, dtype=torch.int64, device=logits.device)
    if top_p is None:
        top_p = torch.ones(b, dtype=torch.float32, device=logits.device)
    return torch.where(_top_kp_mask(logits, top_k, top_p), logits, -torch.inf)


def sampling_probs(logits: torch.Tensor, temperature: torch.Tensor, top_k=None,
                   top_p=None) -> torch.Tensor:
    """[B, V] per-row sampling distribution after top-k -> top-p ->
    temperature: softmax(masked_logits / temperature), a one-hot at the raw
    argmax for greedy rows (temperature <= 0)."""
    greedy = temperature <= 0.0
    t = torch.clamp_min(temperature, 1e-6)[:, None]
    probs = _softmax(_masked_logits(logits, top_k, top_p) / t)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    onehot = vocab[None, :] == torch.argmax(logits, dim=-1, keepdim=True)
    return torch.where(greedy[:, None], onehot.to(probs.dtype), probs)


def _inverse_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[B, V] probs (unnormalized) + [B] uniforms -> [B] int32 indices.

    JAX's blocked search in its summation order: ~sqrt(V) block sums, a
    cumsum over the block totals, then a cumsum inside the chosen block.
    Zero-probability tokens are never drawn."""
    b, v = probs.shape
    nb = 1 << ((v - 1).bit_length() + 1) // 2  # ~sqrt(V), a power of two
    pad = (-v) % nb
    if pad:
        probs = torch.nn.functional.pad(probs, (0, pad))
    vb = probs.shape[1] // nb
    pb = probs.reshape(b, nb, vb)
    cb = torch.cumsum(pb.sum(dim=-1), dim=-1)  # [B, nb] block cdf
    r = u * cb[:, -1]  # threshold in unnormalized mass
    blk = torch.clamp((cb <= r[:, None]).sum(dim=-1), 0, nb - 1)
    prev = torch.gather(cb, 1, torch.clamp_min(blk - 1, 0)[:, None])[:, 0]
    base = torch.where(blk > 0, prev, torch.zeros_like(prev))
    rows = torch.arange(b, device=probs.device)
    cs = base[:, None] + torch.cumsum(pb[rows, blk], dim=-1)
    off = torch.clamp((cs <= r[:, None]).sum(dim=-1), 0, vb - 1)
    return torch.clamp(blk * vb + off, 0, v - 1).to(torch.int32)


def sample_from_probs(probs: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Categorical draw per row: [B, V] probs + [B, 2] keys -> [B] int32,
    one uniform per row (inverse CDF); a one-hot row returns its hot index."""
    return _inverse_cdf(probs, prng.uniform(keys))


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor, temperature: torch.Tensor,
                  top_k=None, top_p=None) -> torch.Tensor:
    """[B] int32 next tokens: greedy rows are the exact raw argmax, sampled
    rows draw from :func:`sampling_probs`' distribution (inverse CDF over the
    unnormalized masked, scaled exponentials; one uniform per row)."""
    greedy = temperature <= 0.0
    t = torch.clamp_min(temperature, 1e-6)[:, None]
    masked = _masked_logits(logits, top_k, top_p)
    w = torch.exp((masked - masked.amax(dim=-1, keepdim=True)) / t)
    sampled = _inverse_cdf(w, prng.uniform(keys))
    return torch.where(greedy, torch.argmax(logits, dim=-1).to(torch.int32), sampled)


def sample_or_argmax(logits: torch.Tensor, samp) -> torch.Tensor:
    """[B] int32 next tokens of a group call: the bare argmax when ``samp``
    is None (an all-greedy group), else :func:`sample_tokens` with keys from
    ``samp = (temperature, top_k, top_p, seed, position)``."""
    if samp is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    temps, top_ks, top_ps, seeds, positions = samp
    return sample_tokens(logits, sample_keys(seeds, positions), temps, top_ks, top_ps)
