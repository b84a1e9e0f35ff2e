"""Builds the port's CUDA kernels from `audiolcm_torch/csrc/*.cu`.

Each source compiles with nvcc into its own shared library with a plain C
interface (loaded with ctypes by the kernel's wrapper), for sm_90a, into
`audiolcm_torch/_build/` (git-ignored). Libraries are named by a hash of
their source and the shared headers (`csrc/*.cuh`), so an edited source or
header rebuilds and an unchanged one is reused. `build_all` starts one nvcc
per source, all at once; a header is only ever compiled through a source.

    python -m audiolcm_torch.build     # build everything, print ptxas stats

`sass_op_counts` reads a built library's machine code (`cuobjdump
--dump-sass`) and counts one opcode per kernel, e.g. HMMA for the tensor
cores' matrix multiply-accumulate.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _cuda_tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    default = f"/usr/local/cuda/bin/{name}"
    if os.path.exists(default):
        return default
    raise RuntimeError(f"{name} not found: the CUDA kernels of audiolcm_torch are built on the "
                       "machine with the GPU")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every shared
    header under csrc/ and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library exists; returns
    (final path, temp path, process or None)."""
    path = library_path(name)
    if path.exists():
        return path, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return path, tmp, proc


def _finish(name: str, path: Path, tmp, proc) -> str:
    if proc is None:
        return f"{name}: reused {path.name}"
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, path)
    return log


def build(name: str) -> Path:
    """Build (or reuse) the library of csrc/<name>.cu and return its path."""
    path, tmp, proc = _start(name)
    _finish(name, path, tmp, proc)
    return path


def build_all() -> dict:
    """Build every csrc/*.cu in parallel; returns {name: nvcc/ptxas log}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def sass_op_counts(name: str, opcode: str) -> dict:
    """{kernel symbol: number of `opcode` instructions} in the SASS of the
    library of csrc/<name>.cu (built or reused)."""
    sass = subprocess.run([_cuda_tool("cuobjdump"), "--dump-sass", str(build(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    op = re.compile(rf"\b{re.escape(opcode)}\b")
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and op.search(line):
            counts[fn] += 1
    return counts


if __name__ == "__main__":
    for kernel, text in build_all().items():
        print(f"== {kernel}\n{text}")
