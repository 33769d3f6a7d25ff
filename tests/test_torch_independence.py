"""The port stands alone and never runs anywhere but where it was asked.

- Importing every module of ``relgat_projector_tpu_torch`` loads neither JAX
  nor the JAX package; no source file of the port, nor ``chip_smoke.py``
  and the two card tools beside it, imports them.
- Without a CUDA device, ``chip_smoke.py`` exits non-zero (from the repo and
  from a directory that holds only the script), and the entry points given
  no device (the model, the graph, the weights bridge, the trainer and the
  CLI) raise instead of running on the CPU.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "relgat_projector_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "relgat_projector_tpu", "optax", "flax",
             "msgpack")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import relgat_projector_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py"))
    + [REPO / n for n in ("chip_smoke.py", "chip_bits.py", "halo_reading.py")],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_sources_import_nothing_of_jax(path):
    bad = set(_imported_roots(path)) & set(FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would drive it")
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, env=_env(), cwd=REPO, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, env=env, cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_entry_points_without_device_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from relgat_projector_tpu_torch.config import ModelConfig
    from relgat_projector_tpu_torch.data.graph import build_graph
    from relgat_projector_tpu_torch.interop import params_from_jax
    from relgat_projector_tpu_torch.models.model import init_model

    cfg = ModelConfig(in_dim=8, num_rel=2, gat_out_dim=4, gat_heads=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_graph(np.array([0]), np.array([1]), np.array([0]), 2, csr=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": np.zeros(2)})


def test_trainer_and_cli_without_device_need_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from relgat_projector_tpu_torch import cli
    from relgat_projector_tpu_torch.config import (
        ModelConfig,
        RunConfig,
        TrainConfig,
    )
    from relgat_projector_tpu_torch.data.synthetic import generate_synthetic_kg
    from relgat_projector_tpu_torch.train.trainer import RelGATTrainer

    kg = generate_synthetic_kg(num_nodes=30, num_edges=100, num_rel=2,
                               emb_dim=8, seed=0)
    run = RunConfig(model=ModelConfig(in_dim=8, num_rel=2, gat_out_dim=4,
                                      gat_heads=2),
                    train=TrainConfig(out_dir=str(tmp_path / "trainer")))
    with pytest.raises(RuntimeError, match="CUDA"):
        RelGATTrainer(run, *kg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--synthetic", "--synthetic-nodes", "30",
                  "--synthetic-edges", "100", "--epochs", "1",
                  "--save-dir", str(tmp_path / "cli")])
    assert not (tmp_path / "cli").exists()
