"""The benchmark's own tests (``python -m pytest benchmark/tests``).

They run on the CPU at tiny sizes, where the program runs its kernels'
plain versions; tests marked ``gpu`` need a card and skip without one,
deciding inside the test. Nothing here imports JAX.
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def tiny_cell(workload: str, **model):
    """The cell ``workload`` at a tiny size: its configuration with 24-wide
    embeddings and 2 heads of 8, batches of 16 with 4 negatives, on 300
    nodes and 3,000 base edges over 5 relations of its traffic's rule."""
    from benchmark import harness

    cell = harness.load_cell(workload)
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["model"].update(in_dim=24, gat_out_dim=8, gat_heads=2,
                                **model)
    cell.config["train"].update(train_batch_size=16, num_neg=4)
    cell.traffic = dict(cell.traffic, num_nodes=300, num_edges=3000,
                        num_rel=5)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
