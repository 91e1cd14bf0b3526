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
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {mods!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print(bad)
        assert not bad, bad
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
    assert engine_mod.resolve_device("cpu") == torch.device("cpu")


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
    from repro_torch.kernels.mpmm import mpmm_cuda

    before = mpmm_cuda.launches
    wd, ws = ops.pack_weights(torch.randn(16, 8), 4)
    ops.mpmm(torch.randn(2, 16), wd, ws, w_bits=4)
    assert mpmm_cuda.launches == before
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
