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


NEW_MODULES = (
    "atdn_vslam_torch.serving",
    "atdn_vslam_torch.eval.kalman",
    "atdn_vslam_torch.cli.kalman",
    "atdn_vslam_torch.cli.visualize",
    "atdn_vslam_torch.data.localization",
    "atdn_vslam_torch.utils.profiling",
    "atdn_vslam_torch.utils.depth",
)


PARALLEL_MODULES = (
    "atdn_vslam_torch.parallel",
    "atdn_vslam_torch.parallel.distributed",
    "atdn_vslam_torch.parallel.mesh",
    "atdn_vslam_torch.parallel.flow_sharding",
    "atdn_vslam_torch.parallel.tensor_parallel",
)


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_modules_import_no_jax(module):
    """Each module of ``atdn_vslam_torch.parallel`` imports in a fresh
    process without JAX, flax, the JAX package or ``tools``."""
    assert module in {name for name, _ in _port_modules()}
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"importlib.import_module({module!r})\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr


def test_parallel_test_worker_imports_no_jax():
    """The ranks of ``tests/test_torch_parallel.py`` import the port alone."""
    tree = ast.parse((REPO / "tests" / "torch_parallel_worker.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
            assert all(n.split(".")[0] not in FORBIDDEN for n in names), names


@pytest.mark.parametrize("module", NEW_MODULES)
def test_serving_and_utility_modules_are_covered(module):
    """The serving export and the remaining utilities are modules of the
    port, and so among those the two tests above import and parse."""
    assert module in {name for name, _ in _port_modules()}


def test_serving_imports_nothing_of_the_models():
    """A serving process loads an artifact through
    ``atdn_vslam_torch.serving``, which registers the kernels' ops and
    imports no module of ``atdn_vslam_torch.models``."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import torch\n"
        "import atdn_vslam_torch.serving\n"
        "assert not [m for m in sys.modules if m.startswith('atdn_vslam_torch.models')]\n"
        "assert hasattr(torch.ops.atdn, 'corr_lookup') and hasattr(torch.ops.atdn, 'corr_dot_tiled')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_the_gpu(monkeypatch, tmp_path):
    """Without a GPU, building the runtime (whose loop closure and
    pose-graph solve run on its device) or a model without ``device=``,
    or running a CLI without ``--device``, raises instead of running on
    the CPU."""
    from atdn_vslam_torch.cli import (
        evaluate_flow,
        evaluate_odometry,
        precompute_flows,
        slam_demo,
        train_flow,
        train_odometry,
    )
    from atdn_vslam_torch.config import Config
    from atdn_vslam_torch.models.factory import build_flow_model, build_flow_train_model, build_odometry_model
    from atdn_vslam_torch.slam import SlamRuntime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(keyframes_path=str(tmp_path / "kf"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlamRuntime(cfg, {}, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_flow_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_odometry_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_flow_train_model(cfg)
    for cli, args in (
        (train_odometry, ["--data-path", str(tmp_path / "data")]),
        (evaluate_odometry, ["--stage", "1", "--data-path", str(tmp_path / "data")]),
        (slam_demo, ["--out-dir", str(tmp_path / "demo"), "--data-path", str(tmp_path / "data")]),
        (train_flow, ["--dataset", "kitti", "--root", str(tmp_path / "k15"), "--output", str(tmp_path / "o.pth")]),
        (evaluate_flow, ["--dataset", "kitti", "--root", str(tmp_path / "k15")]),
        (precompute_flows, ["--sequence", "00", "--data-path", str(tmp_path / "data")]),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(args)
    assert not (tmp_path / "kf").exists() and not (tmp_path / "demo").exists()  # nothing ran
    assert not (tmp_path / "o.pth").exists()


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


def test_slice3_kernel_wrappers_have_no_cpu_fallback_on_other_devices():
    """The same for K2n, K4, K2s and K3t."""
    from atdn_vslam_torch.ops.attention import apply_attention_probs, flash_apply_probs
    from atdn_vslam_torch.ops.corr_dot_tiled import corr_dot_tiled
    from atdn_vslam_torch.ops.corr_lookup_nlanes import nlanes_lookup_levels
    from atdn_vslam_torch.ops.corr_lookup_slab import lookup_corr_pyramid_slab

    probs = torch.empty((1, 2, 2, 8), device="meta")
    values = torch.empty((1, 4, 16), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        flash_apply_probs(probs, values)
    with pytest.raises(RuntimeError, match="no kernel"):
        apply_attention_probs(probs, values, use_pallas=True)
    with pytest.raises(RuntimeError, match="no kernel"):
        nlanes_lookup_levels([torch.empty((1, 2, 2, 4), device="meta")],
                             torch.empty((1, 4, 2), device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        lookup_corr_pyramid_slab([torch.empty((1, 4, 2, 2), device="meta")],
                                 torch.empty((1, 2, 2, 2), device="meta"), orig_rows=(2,))
    with pytest.raises(RuntimeError, match="no kernel"):
        corr_dot_tiled(torch.empty((1, 4, 16), device="meta"),
                       torch.empty((1, 2, 2, 16), device="meta"), 0.25)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from atdn_vslam_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build_all()
