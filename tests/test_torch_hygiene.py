"""Package rules of the PyTorch port: it imports neither JAX nor anything of
the JAX package ``repro`` (checked at run time in a fresh interpreter and by
a static scan of its sources and of chip_smoke.py), and its entry points
default to the card and raise, instead of running on the CPU, when there is
none."""
import os
import pkgutil
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax  # noqa: F401  (the tier-1 environment has both packages)
import pytest
torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch_train  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import jax|from jax|import repro\.|from repro\.|import repro$|from repro import)",
    re.M,
)


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    )


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = _modules()
    assert "repro_torch.kernels.paged_prefill" in mods and len(mods) > 25
    for name in ("core.isa", "core.dataflow", "core.perfmodel", "models.cnn",
                 "models.cnn_zoo", "launch.cnn", "device", "models.ssm",
                 "kernels.mqa_decode", "train.server", "configs.zamba2_7b",
                 "configs.mamba2_130m", "serve.graphs", "core.sau", "core.assembler",
                 "core.interpreter", "quant.quantize", "models.frontends",
                 "configs.paligemma_3b", "configs.musicgen_medium", "optim.optimizers",
                 "optim.schedules", "optim.tree", "data.pipeline", "checkpoint.manager",
                 "distributed.fault", "train.trainer", "launch.train",
                 "distributed.sharding", "distributed.collectives", "distributed.pipeline",
                 "distributed.elastic", "launch.mesh"):
        assert f"repro_torch.{name}" in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {mods!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print(bad)
        assert not bad, bad
        import torch.distributed as dist
        assert not dist.is_initialized()  # importing launch/mesh.py joins no group
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]


def test_sources_do_not_import_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-3b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        engine_mod.ServeEngine(cfg, {})
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tserve.main(["--arch", "llama3.2-3b", "--reduced"])
    for mesh in ([], ["--mesh-data", "1"]):  # before any process group is joined
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tlaunch_train.main(["--arch", "llama3.2-3b", "--reduced", "--steps", "1", *mesh])
    assert not torch.distributed.is_initialized()
    assert engine_mod.resolve_device("cpu") == torch.device("cpu")


def test_static_wave_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.train.server import Server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("zamba2-7b", "mamba2-130m"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Server(get_config(arch).reduced(), {})
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tserve.main(["--arch", arch, "--reduced"])


def test_train_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The training launcher, ``Trainer`` and ``make_batch`` default to the
    card and raise without one; ``--device cpu`` / ``device="cpu"`` is the
    only way onto the CPU."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import train as ttrain
    from repro_torch.train import TrainConfig, Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-3b").reduced()
    data = DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2)
    tc = TrainConfig(ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttrain.main(["--arch", "llama3.2-3b", "--reduced", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(arch=cfg, tc=tc, data=data)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_batch(data, 0)
    assert Trainer(arch=cfg, tc=tc, data=data, device="cpu").device == torch.device("cpu")
    assert ttrain.build_parser().parse_args(["--arch", "x"]).device == "cuda"
    assert not os.listdir(tmp_path)  # nothing was written


def test_cnn_entry_points_raise_without_a_card(monkeypatch):
    """The CNN launcher, init_network and run_network default to the card
    and raise without one; --device cpu is the only way onto the CPU."""
    from repro_torch.launch import cnn as tcnn
    from repro_torch.models import cnn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcnn.main(["--net", "ResNet18", "--layers", "1"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cnn.init_network("ResNet18", 0)
    layers, params = cnn.init_network("ResNet18", 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cnn.run_network("ResNet18", torch.zeros(1, 8, 8, 3), params[:1], layers[:1])
    assert tcnn.build_parser().parse_args([]).device == "cuda"


def test_cuda_tensors_never_reach_the_plain_versions():
    """The dispatch rule: CPU tensors take the plain version, anything else
    that is not CUDA raises; nothing picks a path by catching an error."""
    from repro_torch.kernels import ops

    assert ops.on_card(torch.zeros(1)) is False
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.on_card(torch.zeros(1, device="meta"))
    for f in (PKG / "kernels").glob("*.py"):
        assert "except" not in f.read_text(), f"{f.name} catches an exception"


def test_cpu_tensors_launch_no_kernel_and_a_missing_nvcc_raises(monkeypatch):
    """Plain versions on the CPU leave the launch counters alone; a build
    without nvcc raises instead of falling back."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.mpmm import mpmm_cuda, mpmm_ff_cuda, mpmm_int_cuda
    from repro_torch.kernels.mqa_decode import mqa_decode_cuda

    counters = (mpmm_cuda, mpmm_ff_cuda, mpmm_int_cuda, mqa_decode_cuda)
    before = [fn.launches for fn in counters]
    wd, ws = ops.pack_weights(torch.randn(16, 8), 4)
    for df in ("cf", "ff", "auto"):
        ops.mpmm(torch.randn(2, 16), wd, ws, w_bits=4, dataflow=df)
        ops.mpmm(torch.ones(2, 16, dtype=torch.int16), wd, ws, w_bits=4, mode="int",
                 dataflow=df)
    for bits in (4, 8):
        kv, sc = ops.quantize_kv(torch.randn(1, 4, 2, 8), bits)
        ops.mqa_decode(torch.randn(1, 2, 8), kv, kv, sc, sc,
                       torch.tensor([3], dtype=torch.int32), kv_bits=bits)
    assert [fn.launches for fn in counters] == before
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits nonzero and prints no result line with no card,
    and outside a checkout (a directory holding only the script)."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, even on a machine with one
    for script in (ROOT / "chip_smoke.py", lone):
        proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                              text=True, timeout=300, cwd=script.parent, env=env)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_a_card_mesh_without_nccl_raises(monkeypatch):
    """No gloo fallback on the card: a process group for ``cuda`` is NCCL or
    nothing."""
    from repro_torch.launch.mesh import init_distributed

    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        init_distributed("cuda")
    assert not torch.distributed.is_initialized()
