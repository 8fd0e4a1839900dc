"""Build ``csrc/<name>.cu`` with ``nvcc`` at first use and load it with ctypes.

Each source becomes one shared library with a plain C interface
(``extern "C"`` launchers), compiled for ``sm_90a`` into
``kernels/_build/lib<name>-<digest>.so``; the digest covers every file
in ``csrc/`` and the flags, so an edited source is rebuilt. Several
sources build in parallel (one ``nvcc`` each, all started together).

A failed build raises: there is no fallback to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


@dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float          # 0.0 when the library was already built
    ptxas: str              # nvcc's -Xptxas -v report (registers, smem, spills)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and $PATH); the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names: Iterable[str]) -> Dict[str, BuildResult]:
    """Compile the named sources that are not built yet, all at once."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    procs = {}
    for name in names:
        src = CSRC / f"{name}.cu"
        if not src.is_file():
            raise FileNotFoundError(f"no kernel source {src}")
        out = library_path(name)
        if out.is_file():
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        results[name] = BuildResult(name, out, seconds, stdout + stderr)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name].path
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
