"""Build the CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` to an object, all
sources at once in parallel, then links them into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
under ``build/iq_tool_tpu_torch/<source hash>/`` at the checkout's root.
There is no ``--use_fast_math``: ``sincosf``, ``logf``, ``expf`` and
division stay IEEE, so the kernels stay within rounding of their plain
twins.  Nothing is built when this module is imported; ``library()``
builds on its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "iq_tool_tpu_torch"
_SOURCES = ("banded.cu", "banded_mma.cu", "banded_dc.cu", "pre.cu", "post.cu", "osfft.cu",
            "iq_est.cu", "graph_info.cu")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "iq_banded_apply": [_P, _P, _P, _I, _F, _F, _P, _U, _P, _P, _P, _P, _P, _I,
                        _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _F, _F, _F,
                        _F, _P],
    "iq_banded_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "iq_banded_mma_apply": [_P, _P, _P, _I, _F, _F, _P, _U, _P, _P, _P, _P, _P, _I,
                            _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _F, _F, _F,
                            _F, _P],
    "iq_banded_mma_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    "iq_dc_scratch_bytes": [_I, _I],
    "iq_dc_geometry": [_P],
    "iq_dc_prologue": [_P, _I, _F, _F, _P, ctypes.c_double, _P, _U, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P, _U, _P],
    "iq_dc_carry": [_P, _I, _F, _F, _P, ctypes.c_double, _P, _U, _I, _I, _I, _I,
                    _I, _P, _P, _P, _P, _P, _P, _P, _U, _P],
    "iq_banded_dc_apply": [_P, _I, _F, _F, _P, _U, ctypes.c_double, _P, _P, _P, _I,
                           _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                           _P, _I, _I, _F, _F, _F, _F, _P],
    "iq_dc_block_apply": [_P, _I, _F, _F, _P, _P, _P, ctypes.c_double, _P, _P,
                          _U, _I, _I, _P, _P, _P, _P, _U, _P],
    "iq_pre_apply": [_P, _I, _F, _F, _P, _P, _P, _P, _U, _I, _I, _P, _P, _P],
    "iq_post_apply": [_P, _P, _P, _I, _I, _P, _U, _I, _I, _P, _I, _I, _F, _F,
                      _F, _F, _P],
    "iq_agc_rms_gains": [_P, _P, _I, _I, _I, _I, _P, _P, _F, _F, _F, _F, _F, _I,
                         _P, _P, _P, _P],
    "iq_agc_energies": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    "iq_agc_chain": [_P, _I, _P, _P, _F, _F, _F, _F, _F, _I, _P, _P, _P, _P],
    "iq_osfft_apply": [_P, _P, _I, _P, _P, ctypes.c_longlong, _I, _P, _P, _I,
                       _P, _P, _P, _I, _I, _I, _I, _P, _P, ctypes.c_longlong, _P],
    "iq_estimate": [_P, _I, _F, _F, _P, _P, _L, _L, _I, _P, ctypes.c_double, _P, _P,
                    _P, _P, _L, _L, _I, _F, _F, _F, _F, _F, _I, _I, _I, _I, _P, _P,
                    _P, _P, _P],
    "iq_capture_nodes": [_P, _P],
}
_RESTYPES = {"iq_dc_scratch_bytes": ctypes.c_longlong, "iq_dc_geometry": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in sorted(_CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return _BUILD_ROOT / source_hash()


def build() -> Path:
    """Compile the library if this source hash has none yet; returns its
    path.  The compiler's ``-Xptxas -v`` report is kept beside it as
    ``ptxas.log``."""
    out_dir = build_dir()
    so = out_dir / "libiq_kernels.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in _SOURCES]
    procs = [subprocess.Popen([nvcc, *_FLAGS, "-c", "-o", str(o), str(_CSRC / s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(_SOURCES, objs)]
    logs, failed = [], []
    for s, p in zip(_SOURCES, procs):
        out, _ = p.communicate()
        logs.append(f"== {s}\n{out}")
        if p.returncode != 0:
            failed.append(f"{s} ({p.returncode}):\n{out[-4000:]}")
    tmp = out_dir / f"libiq_kernels.{tag}.so"
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        logs.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr[-4000:]}")
    (out_dir / "ptxas.log").write_text("".join(logs))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)
    return so


def build_log() -> str:
    log = build_dir() / "ptxas.log"
    return log.read_text() if log.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = lib
        return _lib
