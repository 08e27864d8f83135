"""The port stands alone: no module of ``src/repro_torch``, neither
``chip_smoke.py`` nor an ``examples/torch_*.py`` script, imports
``jax`` or anything of the JAX package ``repro`` (an AST scan, so
imports inside functions and under
``TYPE_CHECKING`` count too), the training modules
(``repro_torch.training``, ``repro_torch.launch.train``) and the
sharded training and dry-run modules (``training.sharded``,
``launch.{sharding,specs,dryrun,transform_dryrun,comm_analysis}``,
``models.shardhints``) included.
Every module also imports without a GPU, and the entry points that
default to the card (``ClusterEngine`` on CUDA workers, the ``serve``
and ``train`` CLIs without ``--device cpu``, ``Engine`` for a MoE
model) raise there rather than run on the CPU.
"""
import ast
import importlib
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
FILES = PORT + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "examples").glob("torch_*.py"))
BANNED = ("jax", "jaxlib", "repro")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


def test_every_port_module_imports_without_gpu():
    assert len(PORT) > 20
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT}
    assert {"launch/mesh.py", "core/instance.py", "core/kv_transform.py",
            "core/weight_transform.py", "core/transform_engine.py",
            "kernels/page_migrate.py", "kernels/padded_ffn.py",
            "core/partition.py", "core/events.py", "core/scheduler.py",
            "serving/cluster.py", "launch/serve.py", "core/costmodel.py",
            "core/cluster_sim.py", "core/calibrate.py",
            "models/blocks.py", "models/model.py", "models/convert.py",
            "serving/engine.py", "training/__init__.py",
            "training/data.py", "training/schedule.py",
            "training/optimizer.py", "training/checkpoint.py",
            "training/train_step.py", "launch/train.py",
            "training/sharded.py", "launch/sharding.py", "launch/specs.py",
            "launch/dryrun.py", "launch/transform_dryrun.py",
            "launch/comm_analysis.py", "models/shardhints.py"} <= names
    for p in PORT:
        rel = p.relative_to(ROOT / "src").with_suffix("")
        name = ".".join(rel.parts)
        if name.endswith(".__init__"):
            name = name[:-len(".__init__")]
        importlib.import_module(name)


def test_cluster_and_cli_without_gpu_raise(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.serving.cluster import ClusterEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3-8b").reduced()
    for devices in (["cuda"] * 2, [None] * 2):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ClusterEngine(cfg, devices, n_instances=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])


def test_moe_entry_points_without_gpu_raise(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.serving.engine import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("granite-moe-3b-a800m").reduced()
    for kw in ({}, {"devices": ["cuda"] * 2}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(cfg, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "granite-moe-3b-a800m", "--requests", "1"])


def test_train_cli_without_gpu_raises(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1", "--mesh", "2,2"])
