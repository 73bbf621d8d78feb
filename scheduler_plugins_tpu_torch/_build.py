"""Build and load the port's CUDA kernels.

`csrc/*.cu` files have a plain C interface, so each compiles with one
`nvcc` call into a shared library loaded with `ctypes` — no PyTorch headers,
a build of seconds. Libraries go under `build/kernels/` at the root of the
checkout (git-ignored), named by a hash of the source and the flags, so an
edited source is never served by a stale library. Nothing is built when a
module is imported: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

#: every kernel source of the port, by library name
SOURCES = {"election": CSRC / "election.cu"}

_LIBS: dict[str, ctypes.PyDLL] = {}


def nvcc_path() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile one source unless its library is already built; returns the
    library path. `verbose` adds `-Xptxas -v` (registers, spills) to a
    fresh build and prints the compiler's output."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, out)
    return out


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Compile every source at once, one `nvcc` each, in parallel."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        paths = pool.map(lambda n: build(n, verbose=verbose), SOURCES)
    return dict(zip(SOURCES, paths))


def load(name: str) -> ctypes.PyDLL:
    """The loaded library `name`, built on first use. Loaded as a `PyDLL`:
    its entry points only enqueue a launch and touch no Python object, so
    a call keeps the interpreter lock rather than paying to release and
    take it again."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.PyDLL(str(build(name)))
    return lib
