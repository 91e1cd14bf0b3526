"""The port's data pipeline (``repro_torch/data/pipeline.py``) against the
JAX package's: ``make_batch`` tokens and labels bit-equal for several (seed,
step, host slice), the vlm / audio prefix embeddings as
``tests/test_torch_frontends.py`` holds them (within 1e-6 absolute in
float32), the prefetch order of ``iterate``; and the JAX tests' own
invariants on the port (deterministic replay, host slices composing to the
global batch, the injected bigram rule)."""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs import get_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402


@pytest.mark.parametrize("seed,step,host_slice", [
    (0, 0, None), (3, 17, None), (1, 5, (2, 6)), (7, 1000, (7, 8)),
])
def test_make_batch_bit_equal_to_jax(seed, step, host_slice):
    for vocab, seq in ((1000, 64), (128256, 33)):
        cfg = tpipe.DataConfig(vocab=vocab, seq_len=seq, global_batch=8, seed=seed)
        jcfg = jpipe.DataConfig(vocab=vocab, seq_len=seq, global_batch=8, seed=seed)
        got = tpipe.make_batch(cfg, step, host_slice=host_slice, device="cpu")
        exp = jpipe.make_batch(jcfg, step, host_slice=host_slice)
        assert set(got) == set(exp) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(exp[k]))


@pytest.mark.parametrize("name", ["paligemma-3b", "musicgen-medium"])
def test_prefix_embeddings_of_a_batch(name):
    arch = dataclasses.replace(tget(name).reduced(), dtype="float32")
    jarch = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    cfg = tpipe.DataConfig(vocab=arch.vocab, seq_len=16, global_batch=4, seed=2)
    jcfg = jpipe.DataConfig(vocab=arch.vocab, seq_len=16, global_batch=4, seed=2)
    got = tpipe.make_batch(cfg, 3, arch, host_slice=(1, 4), device="cpu")
    exp = jpipe.make_batch(jcfg, 3, jarch, host_slice=(1, 4))
    assert tuple(got["prefix_emb"].shape) == (3, arch.prefix_len, arch.d_model)
    np.testing.assert_allclose(got["prefix_emb"].numpy(), np.asarray(exp["prefix_emb"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(exp["tokens"]))
    assert "prefix_emb" not in tpipe.make_batch(cfg, 3, tget("llama3.2-3b").reduced(),
                                                device="cpu")


def test_iterate_prefetches_in_order():
    cfg = tpipe.DataConfig(vocab=100, seq_len=8, global_batch=2)
    it = tpipe.iterate(cfg, start_step=5, device="cpu")
    for step in (5, 6, 7):
        b = next(it)
        np.testing.assert_array_equal(
            b["tokens"].numpy(), np.asarray(jpipe.make_batch(cfg, step)["tokens"]))
    it.close()


def test_replay_and_host_slices_compose():
    cfg = tpipe.DataConfig(vocab=1000, seq_len=32, global_batch=8, seed=3)
    a = tpipe.make_batch(cfg, 17, device="cpu")["tokens"]
    assert torch.equal(a, tpipe.make_batch(cfg, 17, device="cpu")["tokens"])
    assert not torch.equal(a, tpipe.make_batch(cfg, 18, device="cpu")["tokens"])
    for width in (2, 4):
        parts = [tpipe.make_batch(cfg, 17, host_slice=(i, i + width), device="cpu")["tokens"]
                 for i in range(0, 8, width)]
        assert torch.equal(torch.cat(parts), a)


def test_labels_are_shifted_tokens_with_the_bigram_rule():
    cfg = tpipe.DataConfig(vocab=1000, seq_len=300, global_batch=4)
    b = tpipe.make_batch(cfg, 0, device="cpu")
    toks, labels = b["tokens"].numpy(), b["labels"].numpy()
    assert toks.shape == labels.shape == (4, 300) and (toks < 1000).all()
    np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])
    pos = np.arange(1, 300)
    rule = pos[(pos % 3) == 2]
    assert np.mean(toks[:, rule] == (toks[:, rule - 1] + 1) % 1000) > 0.95
