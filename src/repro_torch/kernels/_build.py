"""Lazy nvcc build of the port's CUDA kernels, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C launch function (no PyTorch
headers, so ``nvcc`` takes seconds). It is compiled for ``sm_90a`` on first
use into ``kernels/build/``, which git ignores, under a file name keyed by a
hash of the source, of every ``csrc`` header it includes (``#include
"..."``, followed through headers) and of its flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is. Importing this
module needs no ``nvcc`` and no GPU; :func:`load` raises if the build fails.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "EXTRA_FLAGS", "nvcc_flags", "load", "build_log",
           "nvcc_path"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

#: Flags of every kernel; never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
#: Flags of one kernel. No FMA contraction where a kernel must round every
#: operation as the reference does: the two assignment kernels (bit
#: equality), and the fp32 attention kernel (its 3xTF32 split is bit-equal
#: to ``split_tf32_plain``, and its softmax rounds each operation on its
#: own). The bf16 attention kernel's contract is 2e-2 and takes no such
#: flag.
EXTRA_FLAGS = {"coflow_assign_sm90": ("-fmad=false",),
               "coflow_assign_lanes_sm90": ("-fmad=false",),
               "flash_attention_fp32_sm90": ("-fmad=false",)}

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels are built on first use on a machine with the CUDA "
            "toolkit")
    return found


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The flags ``csrc/<name>.cu`` is compiled with."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly
    or through another header, in the order first met."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            cand = (path.parent / inc).resolve()
            if cand.is_file():
                todo.append(cand)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """What nvcc printed (``-Xptxas -v``: registers, shared memory, spills)
    when it built kernel ``name``; empty if it has not been built here."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (cached per process)."""
    if name in _LOADED:
        return _LOADED[name]
    so = _target(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *nvcc_flags(name), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed to build {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(so))
    _LOADED[name] = lib
    return lib
