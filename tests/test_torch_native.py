"""The port's native partition passes (``data/native.py``,
``csrc/graphbuild.cpp``) against the JAX package's native route.

- With both packages' C++ libraries loaded, the port's
  ``partition_node_permutation`` (permutation and statistics),
  ``lpa_partition`` and ``bfs_grow_partition`` equal JAX's exactly, on the
  cases of ``tests/test_torch_partition.py`` (a clustered graph with
  shuffled ids, a pre-clustered one, one too small for the two-level
  route), with one shard, and with no edges. The caps are exact.
- The native route is taken: its result differs from the NumPy route's on
  the shuffled graph, and the native edge cut meets JAX's own bar against
  the NumPy route's (``tests/test_partition.py``: ``cut_native <= 1.3 *
  cut_numpy + 0.02``).
- ``RELGAT_NO_NATIVE`` and a compiler that fails both give ``None`` (the
  reason printed once) and the NumPy route, equal to JAX's NumPy route.
- The library builds from the port's own source into its ``_build/``;
  two processes that build it at once into an empty build directory both
  load it, and leave one library and no temporary file.
- On two gloo ranks, rank 1 on the NumPy route, both ranks end with rank
  0's native permutation and the same ``edge_cut_after``
  (``tests/torch_dist_worker.py partition``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from relgat_projector_tpu.data import native as jax_native
from relgat_projector_tpu.data import partition as jax_partition
from relgat_projector_tpu_torch.data import native, partition
from relgat_projector_tpu_torch.parallel.halo import halo_rows_per_shard

from tests.test_torch_distributed import _run_ranks
from tests.test_torch_partition import _case

REPO = Path(__file__).resolve().parents[1]
CASES = ("shuffled", "preclustered", "small", "one_shard", "no_edges")


def _graph(name):
    if name == "one_shard":
        src, dst, n, _ = _case("small")
        return src, dst, n, 1
    if name == "no_edges":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 200, 4
    return _case(name)


@pytest.fixture
def both_native(monkeypatch):
    """Both packages on their native route, whatever an earlier test in
    this process cached."""
    monkeypatch.delenv("RELGAT_NO_NATIVE", raising=False)
    for mod in (jax_native, native):
        if mod._lib is None:
            monkeypatch.setattr(mod, "_tried", False)
    assert jax_native.load_native() is not None
    assert native.load_native() is not None


@pytest.mark.parametrize("name", CASES)
def test_permutation_equals_jax_native_route(both_native, name):
    src, dst, n, g = _graph(name)
    rows = halo_rows_per_shard(n, g)
    want, want_stats = jax_partition.partition_node_permutation(
        src, dst, n, g, rows)
    got, stats = partition.partition_node_permutation(src, dst, n, g, rows)
    assert np.array_equal(got, want)
    assert stats == want_stats
    caps = np.bincount(np.minimum(np.arange(n) // rows, g - 1), minlength=g)
    for fn in ("bfs_grow_partition", "lpa_partition"):
        labels = getattr(partition, fn)(src, dst, n, caps)
        assert np.array_equal(labels, getattr(jax_partition, fn)(
            src, dst, n, caps))
        # With no edges JAX's BFS growing puts every node in part 0 (the
        # LPA that refines it then restores the caps).
        if fn == "lpa_partition" or src.size:
            assert np.array_equal(np.bincount(labels, minlength=g), caps)


def test_native_route_is_taken_and_meets_jax_cut_bar(both_native,
                                                     monkeypatch):
    src, dst, n, g = _case("shuffled")
    rows = halo_rows_per_shard(n, g)
    caps = np.bincount(np.minimum(np.arange(n) // rows, g - 1), minlength=g)
    nat_perm, nat = partition.partition_node_permutation(src, dst, n, g, rows)
    nat_lpa = partition.lpa_partition(src, dst, n, caps)
    nat_bfs = partition.bfs_grow_partition(src, dst, n, caps)
    assert np.array_equal(np.bincount(nat_lpa, minlength=g), caps)
    assert np.array_equal(np.bincount(nat_bfs, minlength=g), caps)
    monkeypatch.setenv("RELGAT_NO_NATIVE", "1")
    np_perm, numpy_stats = partition.partition_node_permutation(
        src, dst, n, g, rows)
    assert not np.array_equal(nat_perm, np_perm)
    assert not np.array_equal(nat_lpa, partition.lpa_partition(
        src, dst, n, caps))
    assert (nat["edge_cut_after"]
            <= 1.3 * numpy_stats["edge_cut_after"] + 0.02)


@pytest.mark.parametrize("how", ("env", "failing_compiler"))
def test_numpy_route_when_the_library_is_off(monkeypatch, capsys, tmp_path,
                                             how):
    if how == "env":
        monkeypatch.setenv("RELGAT_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("RELGAT_NO_NATIVE", raising=False)
        monkeypatch.setenv("CXX", "false")
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
    assert native.load_native() is None
    assert native.load_native() is None
    printed = capsys.readouterr().out
    assert printed.count("[native] graphbuild unavailable") == (
        0 if how == "env" else 1)
    src, dst, n, g = _case("shuffled")
    rows = halo_rows_per_shard(n, g)
    got, stats = partition.partition_node_permutation(src, dst, n, g, rows)
    monkeypatch.setenv("RELGAT_NO_NATIVE", "1")
    want, want_stats = jax_partition.partition_node_permutation(
        src, dst, n, g, rows)
    assert np.array_equal(got, want) and stats == want_stats


def test_library_builds_from_the_port_alone(both_native):
    """The source and the library live in the port's package, never under
    the JAX package's ``native/``; the library's name carries its digest."""
    pkg = REPO / "relgat_projector_tpu_torch"
    assert native.SOURCE == pkg / "csrc" / "graphbuild.cpp"
    path = native.library_path()
    assert path.parent == pkg / "_build" and path.exists()
    assert path.name.startswith("libgraphbuild-") and path.suffix == ".so"


def test_two_processes_building_at_once_both_load(tmp_path):
    build = tmp_path / "build"
    script = (
        "import sys\n"
        "from pathlib import Path\n"
        "from relgat_projector_tpu_torch.data import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "lib = native.load_native()\n"
        "assert lib is not None\n"
        "print(native.library_path().name)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "RELGAT_NO_NATIVE"}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(build)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    names = {out.strip().splitlines()[-1] for out in outs}
    assert len(names) == 1
    assert sorted(f.name for f in build.iterdir()) == sorted(names)


def test_ranks_take_rank0_native_permutation(tmp_path, both_native,
                                             monkeypatch):
    src, dst, n, g = _case("shuffled")
    rows = halo_rows_per_shard(n, g)
    np.savez(tmp_path / "in.npz", src=src, dst=dst)
    (tmp_path / "in.json").write_text(json.dumps(dict(
        num_nodes=n, shards=g, rows=rows, numpy_ranks=[1])))
    _run_ranks("partition", 2, tmp_path)
    outs = [np.load(tmp_path / f"out_{r}.npz") for r in range(2)]
    assert [bool(o["native"]) for o in outs] == [True, False]
    want, want_stats = jax_partition.partition_node_permutation(
        src, dst, n, g, rows)
    for o in outs:
        assert np.array_equal(o["perm"], want)
        assert float(o["cut_after"]) == want_stats["edge_cut_after"]
    monkeypatch.setenv("RELGAT_NO_NATIVE", "1")
    alone, _ = partition.partition_node_permutation(src, dst, n, g, rows)
    assert not np.array_equal(alone, want)
