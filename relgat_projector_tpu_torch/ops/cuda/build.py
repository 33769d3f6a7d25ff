"""Build the Hopper kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``lib<name>-<digest>.so``
under ``relgat_projector_tpu_torch/_build/`` (listed in ``.gitignore``), at
first use. The digest covers the sources and the flags, so an edited source
never loads a stale library. All sources compile at once, one nvcc process
each. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("relgat_fwd", "relgat_bwd", "gelu_layernorm", "layer_tail")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double
# C signatures of the entry points (csrc/*.cu); each returns cudaGetLastError.
# A bf16 variant takes the same arguments, its h (and g) pointing at bf16;
# relgat_bwd_rel_bf16 also its design.
_FWD = [_P] * 15 + [_I] * 6 + [_F, _F, _I, _I, _U, _F, _I, _P]
_BWD_SRC = [_P] * 15 + [_I] * 6 + [_F, _F, _I, _I, _U, _F, _I, _P]
_BWD_REL = [_P] * 7 + [_I] * 5 + [_P]
_BWD_REL_BF16 = [_P] * 7 + [_I] * 6 + [_P]  # and the design
_GELU_LN_FWD = [_P] * 6 + [_I] * 4 + [_P]
_GELU_LN_BWD = [_P] * 9 + [_I] * 4 + [_P]
_TAIL_FWD = [_P] * 3 + [_L, _D] + [_I] * 3 + [_P]
_TAIL_BWD = [_P] * 4 + [_L, _D] + [_I] * 3 + [_P]
SIGNATURES = {
    "relgat_fwd": ("relgat_fwd", _FWD),
    "relgat_fwd_bf16": ("relgat_fwd", _FWD),
    "relgat_bwd_src": ("relgat_bwd", _BWD_SRC),
    "relgat_bwd_src_bf16": ("relgat_bwd", _BWD_SRC),
    "relgat_bwd_rel": ("relgat_bwd", _BWD_REL),
    "relgat_bwd_rel_bf16": ("relgat_bwd", _BWD_REL_BF16),
    "gelu_ln_fwd": ("gelu_layernorm", _GELU_LN_FWD),
    "gelu_ln_bwd": ("gelu_layernorm", _GELU_LN_BWD),
    "layer_tail_fwd": ("layer_tail", _TAIL_FWD),
    "layer_tail_bwd": ("layer_tail", _TAIL_BWD),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build on a machine with the CUDA "
        "toolkit (PATH or /usr/local/cuda/bin)"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all at once, and
    return each source's compiler log (ptxas registers, shared memory and
    spills). Raises if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in SOURCES:
        so = library_path(name)
        if so.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            so,
        )
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    logs = {}
    for name in SOURCES:
        log_path = library_path(name).with_suffix(".log")
        logs[name] = log_path.read_text() if log_path.exists() else ""
    return logs


def entry_point(fn_name: str):
    """The C entry point ``fn_name`` with its ctypes signature, building and
    loading its library on first use."""
    lib_name, argtypes = SIGNATURES[fn_name]
    with _lock:
        lib = _libs.get(lib_name)
        if lib is None:
            if not library_path(lib_name).exists():
                build_all()
            lib = ctypes.CDLL(str(library_path(lib_name)))
            _libs[lib_name] = lib
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
