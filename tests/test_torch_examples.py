"""The port's examples (``repro_torch/examples/``, the counterparts of the JAX
package's ``examples/``), run in-process with ``--device cpu`` at tiny sizes
where they take sizes: the quickstart's deterministic lines (the 16-bit
product, each program's instruction count and ``out[0,0,:3]``, the first
instructions, the selector's choices and GOPS) equal what the JAX package's
functions compute; ``serve_quantized`` and ``train_lm`` pass their own
assertions (the JAX examples'), and the trained loss falls.  Without a card
and without ``--device cpu`` each raises.  Their card runs are in
``chip_smoke.py``.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.core import assembler as jassembler  # noqa: E402
from repro.core import interpreter as jinterpreter  # noqa: E402
from repro.core import isa as jisa  # noqa: E402
from repro.core import perfmodel as jperf  # noqa: E402
from repro.core.dataflow import ConvLayer as JConvLayer  # noqa: E402
from repro.core.precision import Precision as JPrecision  # noqa: E402
from repro.core.sau import pe_multiply as jpe_multiply  # noqa: E402
from repro_torch.examples import quickstart, serve_quantized, train_lm  # noqa: E402

TINY_LM = ["--steps", "12", "--layers", "2", "--d-model", "64", "--seq", "32", "--batch", "4"]


def test_quickstart_lines_equal_the_jax_packages():
    out = quickstart.main(["--device", "cpu"])
    a, b = -12345, 23456
    assert out["product"] == int(jpe_multiply(jnp.asarray([a]), jnp.asarray([b]),
                                              JPrecision.INT16)[0]) == a * b
    layer = JConvLayer("demo", cin=8, cout=8, k=3, h=6, w=6, stride=1, padding=1)
    rng = np.random.default_rng(0)
    x = rng.integers(-7, 8, (8, 6, 6)).astype(np.int32)
    w = rng.integers(-7, 8, (8, 8, 3, 3)).astype(np.int32)
    for df in (jisa.Dataflow.FF, jisa.Dataflow.CF):
        prog = jassembler.assemble_conv(layer, x, w, JPrecision.INT4, df)
        res = jinterpreter.run_program(prog)
        assert out["programs"][df.name] == (prog.n_instructions,
                                            [int(v) for v in res[0, 0, :3]])
    assert out["first_instructions"] == [jisa.disassemble(wd) for wd in prog.words[:3]]
    for layer in (JConvLayer("conv1x1", 480, 192, 1, 14, 14, 1, 0),
                  JConvLayer("conv3x3", 96, 208, 3, 14, 14, 1, 1)):
        perf = jperf.evaluate_layer(layer, JPrecision.INT16, "mixed")
        assert out["selector"][layer.name] == (
            jperf.select_dataflow(layer, JPrecision.INT16).name, perf.gops, perf.area_eff)
    # W4 weights over 512 x 256: the plain version on the CPU, no launch
    assert out["mpmm"]["payload_bytes"] == 512 * 256 // 2 and out["mpmm"]["launches"] == 0
    assert 0.05 < out["mpmm"]["rel_err"] < 0.2


def test_serve_quantized_keeps_its_assertions():
    out = serve_quantized.main(["--device", "cpu"])
    assert out["tokens_out"] == 12 * (len(serve_quantized.SEED_SPEC)
                                      + len(serve_quantized.SPEC)) + 3 * 8
    assert all(len(s) == 12 for s in out["streams"])
    assert out["payload_bytes"][4] < out["payload_bytes"][8] < out["payload_bytes"][16]
    assert out["graphs"]["captured"] == 0  # eager on the CPU


def test_train_lm_loss_falls(tmp_path):
    out = train_lm.main(["--device", "cpu", "--ckpt-dir", str(tmp_path), *TINY_LM])
    hist = out["history"]
    assert [h["step"] for h in hist] == list(range(12))
    assert hist[-1]["loss"] < hist[0]["loss"] and all(np.isfinite(h["loss"]) for h in hist)
    assert (tmp_path / f"step_{12:09d}").is_dir()  # the last step's checkpoint
    assert out["graphs"]["captured"] == 0  # eager on the CPU


@pytest.mark.parametrize("example,argv", [(quickstart, []), (serve_quantized, []),
                                          (train_lm, TINY_LM)])
def test_examples_raise_without_a_card(monkeypatch, example, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        example.main(argv)
