"""The port stands alone: no module of ``atdn_vslam_torch`` and not
``chip_smoke.py`` imports JAX, flax or the JAX package, and its entry
points run on the GPU unless the caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "atdn_vslam_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "atdn_vslam_tpu", "tools")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


def test_importing_the_port_never_imports_jax():
    modules = [name for name, _ in _port_modules()]
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=str(REPO)
    )
    assert out.returncode == 0, out.stderr
    assert len(modules) >= 20


@pytest.mark.parametrize("path", [p for _, p in _port_modules()] + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_has_no_jax_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_entry_points_default_to_the_gpu(monkeypatch, tmp_path):
    """Without a GPU, building the runtime or a model without
    ``device=`` raises instead of running on the CPU."""
    from atdn_vslam_torch.config import Config
    from atdn_vslam_torch.models.factory import build_flow_model, build_odometry_model
    from atdn_vslam_torch.slam import SlamRuntime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(keyframes_path=str(tmp_path / "kf"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlamRuntime(cfg, {}, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_flow_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_odometry_model(cfg)
    assert not (tmp_path / "kf").exists()  # nothing ran


def test_kernel_wrappers_have_no_cpu_fallback_on_other_devices():
    """A tensor neither on the CPU nor on a CUDA device is refused; the
    CUDA sources are only compiled when a CUDA tensor arrives."""
    from atdn_vslam_torch.ops.attention import attention_probs_spatial, flash_attend
    from atdn_vslam_torch.ops.corr_lookup import corr_dot_rowmajor, lookup_corr_pyramid

    meta = torch.empty((1, 4, 16), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        attention_probs_spatial(meta, meta, 2, 2)
    with pytest.raises(RuntimeError, match="no kernel"):
        flash_attend(meta, meta, meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        corr_dot_rowmajor(meta, meta, 0.25)
    with pytest.raises(RuntimeError, match="no kernel"):
        lookup_corr_pyramid([torch.empty((1, 4, 2, 2), device="meta")],
                            torch.empty((1, 2, 2, 2), device="meta"))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from atdn_vslam_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build_all()
