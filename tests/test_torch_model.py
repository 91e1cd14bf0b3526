"""One serving step of the PyTorch port against the JAX package on a reduced
llama3.2-3b: ``paged_decode_step`` and ``chunk_prefill_step`` with the JAX
weights carried over by ``params_from_numpy``, for W4/W8/W16 weights and
int4/int8/16-bit KV pools.

Checks: logits within tolerance, and the pools after the scatter.  Logit
tolerance on float32: 1e-3 (the two packages sum in another order).  On
bfloat16 the two frameworks round at other places (XLA may keep excess f32
precision inside a fusion, PyTorch rounds after every op), and an int4 KV
pool turns one bf16 step into one int4 step; so the bound there is bf16's
own error on these inputs.  If the port's bf16 step is as close to the
float32 step as JAX's is, the triangle inequality puts the two bf16 results
at most twice that distance apart: the port may stray from the JAX bf16
values at most 2x as far as the JAX bf16 values stray from the same step run
by JAX in float32, in the largest and in the mean difference.  Pool entries the step must not
write (padding rows, slots past the table width, every other position) are
bit-identical; the written entries hold the same values, with int payloads
allowed one LSB where an f32 sum landed on the other side of a rounding
boundary."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve import decode as jdecode  # noqa: E402
from repro.serve import prefill as jprefill  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import decode, prefill  # noqa: E402

N_PAGES, PS = 14, 4
def _check_logits(got, exp, dtype, run_f32):
    """``run_f32()`` runs the same JAX step in float32 (bf16 cases only)."""
    if dtype == "float32":
        np.testing.assert_allclose(got, exp, atol=1e-3, rtol=1e-3)
        return
    diff = np.abs(got - exp)
    noise = np.abs(run_f32()[: len(exp)] - exp)  # JAX's own bf16 error
    assert diff.max() <= 2 * noise.max(), (diff.max(), noise.max())
    assert diff.mean() <= 2 * noise.mean(), (diff.mean(), noise.mean())


def _f32(tree):
    """bf16 leaves (params or pools) widened to f32, exactly."""
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, tree
    )


def _setup(dtype, w_bits, kv_bits, seed):
    cfg = dataclasses.replace(
        get_config("llama3.2-3b").reduced(), dtype=dtype, serve_kv_bits=kv_bits
    )
    params = jT.init_params(cfg, jax.random.PRNGKey(seed))
    if w_bits < 16:
        params = jT.quantize_params(params, w_bits)
    ours = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    from repro_torch.configs import get_config as tget

    tcfg = dataclasses.replace(
        tget("llama3.2-3b").reduced(), dtype=dtype, serve_kv_bits=kv_bits
    )
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, N_PAGES, PS, cfg.n_kv_heads, cfg.hd // 2 if kv_bits == 4 else cfg.hd)
    if kv_bits < 16:
        pools = [rng.integers(-100, 100, shape).astype(np.int8) for _ in range(2)]
        pools += [(rng.random((*shape[:-1], 1)) * 0.05).astype(np.float32) for _ in range(2)]
    else:
        jd = jnp.dtype(dtype)
        pools = [np.asarray(jnp.asarray(rng.normal(size=shape), jd)) for _ in range(2)]
        pools += [None, None]
    return cfg, tcfg, params, ours, pools, rng


def _jax_pools(pools):
    return [None if p is None else jnp.asarray(p) for p in pools]


def _torch_pools(pools):
    return [None if p is None else params_from_numpy({"x": p}, "cpu")["x"] for p in pools]


def _as_np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _payload_np(p, kv_bits):
    """A pool (JAX array or torch tensor) as numpy, int4 nibbles unpacked."""
    a = p.float().numpy() if isinstance(p, torch.Tensor) and p.dtype == torch.bfloat16 else (
        p.numpy() if isinstance(p, torch.Tensor) else np.asarray(_f32(p)))
    if kv_bits == 4 and a.dtype == np.int8:
        lo = (a.astype(np.int8) << 4).astype(np.int8) >> 4
        a = np.stack([lo, a >> 4], axis=-1).reshape(*a.shape[:-1], -1)
    return a


def _check_pools(jpools, tpools, written, kv_bits, dtype, f32_pools):
    """``written``: [(page, offset)] positions the step wrote.  Untouched
    entries must be bit-identical.  Written entries: on float32 the same
    values (int payloads one LSB apart at most, where an f32 sum rounded the
    other way); on bfloat16 within the bf16 noise of the logit check,
    measured on the same entries of the float32 JAX run (``f32_pools()``)."""
    mask = np.ones(np.asarray(jpools[0]).shape[1:3], bool)
    for page, off in written:
        mask[page, off] = False
    f32 = f32_pools() if dtype == "bfloat16" else None
    for i, (jp, tp) in enumerate(zip(jpools, tpools)):
        if jp is None:
            assert tp is None
            continue
        a, b = _payload_np(jp, kv_bits), _payload_np(tp, kv_bits)
        np.testing.assert_array_equal(a[:, mask], b[:, mask])  # untouched: exact
        a, b = a[:, ~mask].astype(np.float64), b[:, ~mask].astype(np.float64)
        if f32 is not None:
            noise = np.abs(_payload_np(f32[i], kv_bits)[:, ~mask] - a)
            diff = np.abs(b - a)
            assert diff.max() <= 2 * noise.max() + 1e-6, (i, diff.max(), noise.max())
            assert diff.mean() <= 2 * noise.mean() + 1e-6, (i, diff.mean(), noise.mean())
        elif jp.dtype == jnp.int8:
            assert np.abs(a - b).max() <= 1, i
        else:
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4, err_msg=str(i))


CASES = [(16, 16), (8, 8), (4, 4), (8, 4), (4, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_bits,kv_bits", CASES)
def test_paged_decode_step_matches_jax(dtype, w_bits, kv_bits):
    cfg, tcfg, params, ours, pools, rng = _setup(dtype, w_bits, kv_bits, seed=w_bits + kv_bits)
    w = 3
    tables = np.array([[3, 7, 1], [0, 2, 0], [5, 6, 8], [9, 10, 11]], np.int32)
    # empty row, mid-page row, full table (append past W: dropped), padding row
    lengths = np.array([0, 5, w * PS, 2], np.int32)
    valid = np.array([True, True, True, False])
    tokens = rng.integers(0, cfg.vocab, (4, 1)).astype(np.int32)
    step = jax.jit(jdecode.paged_decode_step, static_argnames=("cfg",))
    args = (jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(tables), jnp.asarray(valid))
    jlog, jpools = step(params, *args, *_jax_pools(pools), cfg=cfg)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tpools = _torch_pools(pools)
    tlog, out_pools = decode.paged_decode_step(
        ours, torch.from_numpy(tokens), torch.from_numpy(lengths),
        torch.from_numpy(tables), torch.from_numpy(valid), *tpools, cfg=tcfg,
    )
    assert all(a is b for a, b in zip(out_pools, tpools))  # updated in place
    _check_logits(tlog.numpy(), np.asarray(jlog), dtype, lambda: np.asarray(
        step(_f32(params), *args, *_f32(_jax_pools(pools)), cfg=cfg32)[0]))
    assert (tlog.numpy()[:, cfg.vocab:] == -1e30).all()
    written = [(3, 0), (2, 1)]  # rows 0 and 1; row 2 is past W, row 3 padding
    _check_pools(jpools, tpools, written, kv_bits, dtype, lambda: step(
        _f32(params), *args, *_f32(_jax_pools(pools)), cfg=cfg32)[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_bits,kv_bits", CASES)
def test_chunk_prefill_step_matches_jax(dtype, w_bits, kv_bits):
    cfg, tcfg, params, ours, pools, rng = _setup(dtype, w_bits, kv_bits, seed=3 * w_bits + kv_bits)
    c = 6
    tables = np.array([[3, 7, 1, 4], [0, 2, 12, 13], [5, 6, 8, 9]], np.int32)
    q_start = np.array([0, 5, 3], np.int32)
    q_lens = np.array([6, 4, 0], np.int32)  # ragged; row 2 is a padding row
    tokens = rng.integers(0, cfg.vocab, (3, c)).astype(np.int32)
    step = jax.jit(jprefill.chunk_prefill_step, static_argnames=("cfg",))
    args = (jnp.asarray(tokens), jnp.asarray(q_start), jnp.asarray(q_lens), jnp.asarray(tables))
    jlog, jpools = step(params, *args, *_jax_pools(pools), cfg=cfg)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tpools = _torch_pools(pools)
    tlog, _ = prefill.chunk_prefill_step(
        ours, torch.from_numpy(tokens), torch.from_numpy(q_start),
        torch.from_numpy(q_lens), torch.from_numpy(tables), *tpools, cfg=tcfg,
    )
    _check_logits(tlog.numpy()[:2], np.asarray(jlog)[:2], dtype, lambda: np.asarray(
        step(_f32(params), *args, *_f32(_jax_pools(pools)), cfg=cfg32)[0]))
    written = [(tables[b, p // PS], p % PS)
               for b in range(3) for p in range(q_start[b], q_start[b] + q_lens[b])]
    _check_pools(jpools, tpools, written, kv_bits, dtype, lambda: step(
        _f32(params), *args, *_f32(_jax_pools(pools)), cfg=cfg32)[1])
