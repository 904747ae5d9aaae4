"""Build the CUDA kernels of ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). Libraries go to ``build/kernels/`` at the repository
root, named by a hash of the sources and flags, so an unchanged kernel is
built once per checkout. Every requested source is compiled in parallel, one
``nvcc`` each. ``-Xptxas -v`` makes nvcc report each kernel's registers,
shared memory and spills; the report is kept beside the library.
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("paged_attention", "flash_prefill")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    name: str
    path: Path
    ptxas: str        # nvcc's -Xptxas -v report
    seconds: float    # 0.0 when the library was already built


_built: Dict[str, Built] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "repro_torch are built on the machine with the card")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Built]:
    """Build (or find already built) the named kernels; one nvcc process per
    source, all started together. Raises with nvcc's output on failure."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name in _built:
            continue
        path = _library_path(name)
        log = path.with_suffix(".log")
        if path.is_file() and log.is_file():
            _built[name] = Built(name, path, log.read_text(), 0.0)
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       path, tmp, time.perf_counter())
    failures = []
    for name, (proc, path, tmp, t0) in procs.items():
        output, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name} (exit {proc.returncode})\n{output}")
            continue
        os.replace(tmp, path)
        path.with_suffix(".log").write_text(output)
        _built[name] = Built(name, path, output, seconds)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return {n: _built[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build([name])[name].path))
    return _libs[name]
