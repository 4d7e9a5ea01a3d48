"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
``ptxas`` reports each kernel's registers, spills and shared memory
(``-Xptxas -v``); the report is kept beside the library
(:func:`build_log`).
The build happens at first use, keyed by a hash of the sources and the
flags, into ``build/repro_torch/<hash>/`` under the checkout (a directory
``.gitignore`` lists); ``REPRO_TORCH_BUILD_DIR`` moves it. A finished
build is reused; a build is written to a temporary directory and renamed
into place, so concurrent processes never load a half-written library.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` (the CPU tests), and only :func:`library` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["library", "build_seconds", "build_log", "check", "SOURCES",
           "HEADERS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("quant_matmul.cu", "edge_softmax.cu", "mddq_encode.cu",
           "act_quant.cu", "attention_int8kv.cu")
# included by the sources above: hashed with them, so an edit rebuilds
HEADERS = ("act_quant.cuh",)
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOG = "nvcc.log"

_P, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float
# C entry points: (name, argtypes); every entry returns a cudaError_t
_SIGNATURES = {
    "repro_qmm_w8a8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "repro_qmm_w4a8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "repro_qmm_w8a8_f32a": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "repro_qmm_w4a8_f32a": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "repro_edge_softmax": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _P),
    "repro_mddq_encode": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _F, _F, _F, _F, _I, _P),
    "repro_mddq_encode_band": (_P, _P, _P, _P, _I, _I, _I, _I,
                               _F, _F, _F, _F, _I, _P),
    "repro_act_quant_f32": (_P, _P, _P, _I, _I, _I, _P),
    "repro_act_quant_bf16": (_P, _P, _P, _I, _I, _I, _P),
    "repro_kv_append_int8_f32": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _P, _I, _I, _P),
    "repro_kv_append_int8_bf16": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _P, _I, _I, _P),
    "repro_decode_attention_int8kv": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                      _P, _F, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_seconds = 0.0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from src/repro_torch/kernels/csrc")
    return found


def _build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        obj = out_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *_FLAGS, "-c", str(_CSRC / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors, logs = [], []
    for name, p in procs:
        out, _ = p.communicate()
        text = f"{name}:\n{out.decode(errors='replace')}"
        logs.append(text)
        if p.returncode != 0:
            errors.append(text)
    if errors:
        raise RuntimeError("nvcc failed\n" + "\n".join(errors))
    (out_dir / _LOG).write_text("\n".join(logs))
    objs = [str(out_dir / (Path(n).stem + ".o")) for n in SOURCES]
    res = subprocess.run(
        [nvcc, *_FLAGS, "-shared", *objs, "-o", str(out_dir / "libkernels.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed\n"
                           + res.stdout.decode(errors="replace"))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, _build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.monotonic()
        final = _build_root() / _source_hash()
        so = final / "libkernels.so"
        if not so.exists():
            final.parent.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=final.parent))
            try:
                _compile(tmp)
                try:
                    os.replace(tmp, final)
                except OSError:
                    if not so.exists():    # lost a race to nothing: re-raise
                        raise
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        _build_seconds = time.monotonic() - t0
        return lib


def build_log() -> str:
    """nvcc's output for the loaded library's sources, ptxas's report of
    every kernel included."""
    library()
    return (_build_root() / _source_hash() / _LOG).read_text()


def build_seconds() -> float:
    """Seconds the first :func:`library` call spent building and loading."""
    return _build_seconds


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")
