"""ctypes bindings for the host partition passes (``csrc/graphbuild.cpp``).

Port of ``relgat_projector_tpu/data/native.py``, its label-propagation and
BFS-growing passes. ``csrc/graphbuild.cpp`` is the port's copy of the JAX
package's C++ passes, so both packages relabel a graph alike. It is host
C++ (integer arithmetic only), built at first use with the host's ``g++``
(``$CXX`` if set) and the JAX package's flags into
``relgat_projector_tpu_torch/_build/libgraphbuild-<digest>.so``. The digest
covers the source, the flags and the target that ``-march=native``
resolves to on this host, so an edited source or another CPU never loads a
stale library. A build writes a temporary file and ``os.replace``-s it into
place, so processes that build at once (test workers, the ranks of a grid)
each load a whole library.

``load_native`` returns ``None`` when ``RELGAT_NO_NATIVE`` is set, or when
the library cannot be built or loaded, printing the reason once; the
callers in ``data/partition.py`` then take the NumPy route, as in the JAX
package. The two routes give different partitions, which is why
``partition_node_permutation`` broadcasts rank 0's permutation on a grid.

The JAX package's other native exports (``blocked_phase1/2``,
``compact_and_filter``) build the TPU's block-padded layout; the port's
kernels read CSR (``data/csr.py``), so they have no counterpart here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "csrc" / "graphbuild.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_I64P = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _compiler() -> str:
    return os.environ.get("CXX") or shutil.which("g++") or "g++"


def library_path(cxx: Optional[str] = None) -> Path:
    """Where this host's build of ``csrc/graphbuild.cpp`` lives."""
    cxx = cxx or _compiler()
    target = subprocess.run(
        [cxx, "-march=native", "-Q", "--help=target"],
        check=True, capture_output=True, text=True,
    ).stdout
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((cxx,) + CXX_FLAGS).encode())
    h.update(target.encode())
    return BUILD_DIR / f"libgraphbuild-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """The library's path, compiling it first if it is missing. Raises
    ``subprocess.CalledProcessError`` (with the compiler's output) if the
    compile fails."""
    cxx = _compiler()
    so = library_path(cxx)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{so.name}.", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load_native() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if os.environ.get("RELGAT_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build_library()))
            lib.lpa_refine.argtypes = [_I64P, _I64P, _I64, _I64, _I64,
                                       _I64P, _I64P, _I64, _I64P]
            lib.lpa_refine.restype = ctypes.c_int64
            lib.bfs_grow.argtypes = [_I64P, _I64P, _I64, _I64, _I64, _I64P,
                                     _I64P]
            lib.bfs_grow.restype = None
            _lib = lib
        except Exception as exc:  # no toolchain / unreadable: numpy route
            stderr = (getattr(exc, "stderr", None) or "").strip()
            detail = f": {stderr}" if stderr else ""
            print(f"[native] graphbuild unavailable ({exc}{detail}); "
                  "using NumPy path")
            _lib = None
        return _lib


def _edges(src, dst, num_nodes: int):
    """``src``/``dst`` as contiguous int64, checked to name nodes of
    ``[0, num_nodes)``: the C passes index with them unchecked."""
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError(f"edge lists of shapes {src.shape} and {dst.shape}")
    if src.size and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= num_nodes):
        raise ValueError(f"edge endpoints outside [0, {num_nodes})")
    return src, dst


def native_lpa_refine(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    caps: np.ndarray,
    soft_caps: np.ndarray,
    init_labels: np.ndarray,
    max_passes: int,
) -> Optional[np.ndarray]:
    """Async size-constrained label propagation + exact-caps repair in C++
    (``csrc/graphbuild.cpp lpa_refine``); None if the native library is
    unavailable or rejects the input (the NumPy route then applies)."""
    lib = load_native()
    if lib is None:
        return None
    src, dst = _edges(src, dst, num_nodes)
    caps = np.ascontiguousarray(caps, np.int64)
    soft_caps = np.ascontiguousarray(soft_caps, np.int64)
    labels = np.ascontiguousarray(init_labels, np.int64).copy()
    if (soft_caps.shape != caps.shape or labels.shape != (num_nodes,)
            or (labels.size and (labels.min() < 0
                                 or labels.max() >= caps.shape[0]))):
        raise ValueError("soft caps or initial labels do not fit the caps")
    rc = lib.lpa_refine(
        _i64p(src), _i64p(dst), src.shape[0], int(num_nodes),
        caps.shape[0], _i64p(caps), _i64p(soft_caps), int(max_passes),
        _i64p(labels),
    )
    if rc < 0:
        return None
    return labels


def native_bfs_grow(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    caps: np.ndarray,
) -> Optional[np.ndarray]:
    """Greedy BFS-wave graph growing in C++; None if unavailable."""
    lib = load_native()
    if lib is None:
        return None
    src, dst = _edges(src, dst, num_nodes)
    caps = np.ascontiguousarray(caps, np.int64)
    labels = np.empty(int(num_nodes), np.int64)
    lib.bfs_grow(
        _i64p(src), _i64p(dst), src.shape[0], int(num_nodes),
        caps.shape[0], _i64p(caps), _i64p(labels),
    )
    return labels
