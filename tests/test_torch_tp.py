"""The tensor-parallel (TP) mapping's building blocks in the port
(``repro_torch/distributed/sharding.py``, ``models/layers.py``) against their
unsplit forms, on 4 gloo ranks of a 2 x 2 ("data", "model") mesh under
``sharding.use_mesh(mesh)``: each rank holds its rows of the batch (over
``data``) and its stored blocks of the weights (``tree_shardings``).

- ``gather_weight`` keeps the stored model block (gathered over ``data``),
  ``gather_whole`` gives the whole weight, ``model_block`` cuts a model
  block along a dim the stored sharding does not split over ``model``;
- ``dense`` column-split (``wq``'s layout) and row-split (``wo``'s), in
  float32 with the gradients of the input and of the weight's block, in
  bf16 (the row split with its gradients too), and with W8 / W4 payloads
  (forward) in float32 and in bf16: against ``dense`` on the whole weight;
- the f / g pair: ``model_enter`` is the identity forward and sums the
  gradient over ``model``; ``model_reduce`` sums over ``model`` forward and
  passes the gradient as it is;
- the vocab-split embedding lookup and ``chunked_cross_entropy`` over the
  vocab-split unembedding (three chunks, a padded vocab), with gradients.

Tolerances: float32 and the quantized column splits within 1e-6 (the same
products per column); float32 row splits within 1e-5 (f32 partials summed
over the ranks); bf16 column splits bit-equal; bf16 row splits, plain and
W8 / W4, within one bf16 ulp of the unsplit product (|diff| <= 2^-7 |ref| +
1e-6: each rank's partial stays f32, the kernel's scaled f32 sum for a
quantized weight, and the sum over the ranks is cast once, so only the
order of the f32 sums differs), their gradients within rtol 1e-2 (the
weight's summed over the data ranks in bf16); the embedding bit-equal; the
cross-entropy within 1e-6 (its logsumexp from the ranks' max and sum of
exps).
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro_torch.distributed import sharding as sh  # noqa: E402
from test_torch_sharding import run_ranks  # noqa: E402

_UNITS = """
    import numpy as np
    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers
    from repro_torch.models.transformer import quantize_dense_weight

    mesh = make_test_mesh(2, 2, device="cpu")
    d_rank, m_rank = mesh.get_coordinate()
    gen = torch.Generator().manual_seed(0)
    B, K, N = 4, 16, 12
    rows = slice(d_rank * B // 2, (d_rank + 1) * B // 2)

    def blocks(name, full):
        s = sh.tree_shardings({name: full}, mesh)[name]
        if isinstance(full, dict):
            return {k: (sh.shard_local(full[k], s[k]) if k != "bits" else full[k]) for k in full}
        return sh.shard_local(full, s)

    def close(a, b, tol, what):
        a, b = a.float(), b.float()
        ok = torch.allclose(a, b, rtol=tol, atol=tol)
        assert ok, (what, float((a - b).abs().max()))

    def one_ulp(a, b, what):
        a, b = a.float(), b.float()
        ok = bool(((a - b).abs() <= b.abs() * 2 ** -7 + 1e-6).all())
        assert ok, (what, float((a - b).abs().max()))

    x = torch.randn(B, K, generator=gen)
    w = torch.randn(K, N, generator=gen) / K ** 0.5
    r = torch.randn(B, N, generator=gen)
    cb = slice(m_rank * N // 2, (m_rank + 1) * N // 2)
    kb = slice(m_rank * K // 2, (m_rank + 1) * K // 2)

    # gather_weight keeps the stored model block; gather_whole and model_block
    wq, wo = blocks("wq", w), blocks("wo", w)
    with sh.use_mesh(mesh):
        assert torch.equal(sh.gather_weight(wq), w[:, cb])
        assert torch.equal(sh.gather_weight(wo), w[kb])
        assert torch.equal(sh.gather_whole(wq), w)
        assert torch.equal(sh.model_block(wq, 0), w[kb])
        assert sh.model_dim(wq) == 1 and sh.model_dim(wo) == 0

    # column split (wq's layout) and row split (wo's), float32, with grads
    xf = x.clone().requires_grad_(True)
    wf = w.clone().requires_grad_(True)
    out = layers.dense(xf, wf)
    (out * r).sum().backward()
    for split, name, xs in (("cols", "wq", x[rows]), ("rows", "wo", x[rows][:, kb])):
        blk = blocks(name, w).requires_grad_(True)
        xr = xs.clone().requires_grad_(True)
        with sh.use_mesh(mesh):
            got = layers.dense(xr, blk, split)
            want = out.detach()[rows][:, cb] if split == "cols" else out.detach()[rows]
            cot = r[rows][:, cb] if split == "cols" else r[rows]
            (got * cot).sum().backward()
        tol = 1e-6 if split == "cols" else 1e-5
        close(got, want, tol, f"{split} forward")
        gx = xf.grad[rows] if split == "cols" else xf.grad[rows][:, kb]
        close(xr.grad, gx, tol, f"{split} input grad")
        s = blk._mesh_sharding
        close(blk.grad, wf.grad[s.index(tuple(w.shape))], tol, f"{split} weight grad")

    # bf16
    xb, wb = x.bfloat16(), w.bfloat16()
    ref = layers.dense(xb, wb)
    with sh.use_mesh(mesh):
        assert torch.equal(layers.dense(xb[rows], blocks("wq", wb), "cols"), ref[rows][:, cb])
        got = layers.dense(xb[rows][:, kb], blocks("wo", wb), "rows")
    assert got.dtype == torch.bfloat16
    close(got, ref[rows], 1e-2, "bf16 rows")
    one_ulp(got, ref[rows], "bf16 rows")

    # bf16 row split with its gradients
    xg, wg = xb.clone().requires_grad_(True), wb.clone().requires_grad_(True)
    rb = r.bfloat16()
    (layers.dense(xg, wg) * rb).sum().backward()
    blk = blocks("wo", wb).requires_grad_(True)
    xr = xb[rows][:, kb].clone().requires_grad_(True)
    with sh.use_mesh(mesh):
        got = layers.dense(xr, blk, "rows")
        (got * rb[rows]).sum().backward()
    assert xr.grad.dtype == blk.grad.dtype == torch.bfloat16
    close(xr.grad, xg.grad[rows][:, kb], 1e-2, "bf16 rows input grad")
    close(blk.grad, wg.grad[blk._mesh_sharding.index(tuple(w.shape))], 1e-2,
          "bf16 rows weight grad")

    # W8 / W4 payloads (int4 packs K in pairs: each rank's K block is even)
    for bits in (8, 4):
        q = quantize_dense_weight(w, bits)
        ref = layers.dense(x, q)
        with sh.use_mesh(mesh):
            got_c = layers.dense(x[rows], blocks("wq", q), "cols")
            got_r = layers.dense(x[rows][:, kb], blocks("wo", q), "rows")
        close(got_c, ref[rows][:, cb], 1e-6, f"w{bits} cols")
        close(got_r, ref[rows], 1e-5, f"w{bits} rows")
        ref = layers.dense(xb, q)  # bf16 activations, as served
        with sh.use_mesh(mesh):
            got_r = layers.dense(xb[rows][:, kb], blocks("wo", q), "rows")
        assert got_r.dtype == torch.bfloat16
        one_ulp(got_r, ref[rows], f"w{bits} bf16 rows")

    # the f / g pair
    v = torch.full((3,), float(RANK + 1), requires_grad=True)
    with sh.use_mesh(mesh):
        y = sh.model_reduce(v * 1.0)
        peers = [d_rank * 2 + m for m in range(2)]
        assert torch.equal(y.detach(), torch.full((3,), float(sum(p + 1 for p in peers))))
        y.backward(torch.full((3,), 2.0))
        assert torch.equal(v.grad, torch.full((3,), 2.0))
        u = torch.ones(3, requires_grad=True)
        z = sh.model_enter(u)
        assert torch.equal(z.detach(), u.detach())
        z.backward(torch.full((3,), float(RANK + 1)))
        assert torch.equal(u.grad, torch.full((3,), float(sum(p + 1 for p in peers))))

    # vocab-split embedding
    V, D = 16, 8
    emb = torch.randn(V, D, generator=gen)
    tok = torch.randint(0, V, (B, 5), generator=gen)
    re = torch.randn(B, 5, D, generator=gen)
    ef = emb.clone().requires_grad_(True)
    (layers.embed_lookup(ef, tok, torch.float32) * re).sum().backward()
    eb = blocks("embed", emb).requires_grad_(True)
    with sh.use_mesh(mesh):
        got = layers.embed_lookup(eb, tok[rows], torch.float32)
        (got * re[rows]).sum().backward()
    assert torch.equal(got, emb[tok[rows]])
    close(eb.grad, ef.grad[eb._mesh_sharding.index((V, D))], 1e-6, "embed grad")

    # cross-entropy over the vocab-split unembedding: 3 chunks, pad vocab
    S = 6
    h = torch.randn(B, S, D, generator=gen)
    un = torch.randn(D, V, generator=gen)
    lab = torch.randint(0, V - 3, (B, S), generator=gen)
    mask = (torch.rand(B, S, generator=gen) > 0.2).float()
    hf, uf = h.clone().requires_grad_(True), un.clone().requires_grad_(True)
    ref = layers.chunked_cross_entropy(hf, uf, lab, mask, vocab=V - 3,
                                       max_chunk_elems=B * 2 * V // 4)
    ref.backward()
    ub = blocks("unembed", un).requires_grad_(True)
    hr = h[rows].clone().requires_grad_(True)
    with sh.use_mesh(mesh):
        share = layers.chunked_cross_entropy(hr, ub, lab[rows], mask[rows], vocab=V - 3,
                                             max_chunk_elems=B * 2 * V // 4)
        share.backward()
        total = sh.batch_all_reduce(share.detach().clone())
    close(total, ref.detach(), 1e-6, "ce")
    close(hr.grad, hf.grad[rows], 1e-6, "ce h grad")
    close(ub.grad, uf.grad[ub._mesh_sharding.index((D, V))], 1e-6, "ce unembed grad")
    print("units ok")
"""


def test_tp_units_on_2x2(tmp_path):
    outs = run_ranks(_UNITS, 4, tmp_path, timeout=120)
    assert all("units ok" in o for o in outs), outs


class _Mesh:
    """The axis names and sizes of a mesh (what the rule reads)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("shape,n,splits", [
    ((2, 2), 2, True), ((1, 4), 2, False), ((1, 4), 8, True), ((4, 1), 3, True),
    ((16, 16), 8, False)])
def test_split_rule(shape, n, splits):
    """The rule of a hand-partitioned TP layer: split where the model axis
    divides (reduced llama's 2 kv heads split on 2, not on 4; mixtral's 8
    experts not on 16); nothing splits under the FSDP mapping."""
    with sh.use_mesh(_Mesh(shape)):
        assert sh.model_splits(n) is splits
        assert sh.batch_axes() == ("data",) and sh.model_axis() == "model"
    with sh.use_mesh(_Mesh(shape), data_only=True):
        assert not sh.model_splits(n)
    assert not sh.model_splits(n)


def test_mapping_of_a_mesh_step():
    mesh = _Mesh((2, 2))
    assert sh.mapping_of(mesh) == "fsdp"  # nothing installed: the FSDP default
    with sh.use_mesh(mesh):
        assert sh.mapping_of(mesh) == "tp"
        assert sh.mapping_of(_Mesh((2, 2))) == "fsdp"  # another mesh
    with sh.use_mesh(mesh, data_only=True):
        assert sh.mapping_of(mesh) == "fsdp"


def test_moe_mesh_step_needs_the_tp_mapping():
    """MoE archs train on a mesh under the TP mapping; the FSDP mapping
    (installed, or no mapping at all) still refuses them, naming the TP
    mapping."""
    from repro_torch.configs import get_config
    from repro_torch.train import TrainConfig, make_train_step

    arch, tc, mesh = get_config("mixtral-8x22b").reduced(), TrainConfig(), _Mesh((2, 2))
    with sh.use_mesh(mesh):
        step_fn, _ = make_train_step(arch, tc, mesh)
        assert callable(step_fn)
    for ctx in (sh.use_mesh(mesh, data_only=True), sh.use_mesh(None)):
        with ctx, pytest.raises(NotImplementedError, match="tensor-parallel mapping"):
            make_train_step(arch, tc, mesh)
