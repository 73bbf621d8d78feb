"""Build and load the port's CUDA kernels and its host C++ library.

`csrc/*.cu` files have a plain C interface, so each compiles with one
`nvcc` call into a shared library loaded with `ctypes` — no PyTorch headers,
a build of seconds. Libraries go under `build/kernels/` at the root of the
checkout (git-ignored), named by a hash of the source and the flags, so an
edited source is never served by a stale library. Nothing is built when a
module is imported: the first launch builds.

The host C++ sources (the native columnar store `bridge/snapshot_store.cc`
and the compiled baselines `bridge/ref_baseline.cc`) build with one `g++`
call each into `build/native/` under the same naming rule, on first use
or through `build_all`. Without `g++` that build raises: nothing falls
back to Python.
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

HOST_BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
#: every host C++ source of the port, by library name
HOST_SOURCES = {
    "snapshot_store": PACKAGE_DIR / "bridge" / "snapshot_store.cc",
    "ref_baseline": PACKAGE_DIR / "bridge" / "ref_baseline.cc",
}

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


def host_library_path(name: str) -> Path:
    src = HOST_SOURCES[name]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(HOST_FLAGS).encode()
    ).hexdigest()[:16]
    return HOST_BUILD_DIR / f"lib{name}-{digest}.so"


def build_host(name: str) -> Path:
    """Compile one host C++ source with g++ unless its library is already
    built; returns the library path."""
    out = host_library_path(name)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            f"g++ not found: {HOST_SOURCES[name]} needs a host C++ compiler")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *HOST_FLAGS,
           str(HOST_SOURCES[name]), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed for {HOST_SOURCES[name]} (exit {proc.returncode}):"
            f"\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Compile every source at once, one `nvcc` or `g++` each, in
    parallel."""
    jobs = [(n, lambda n=n: build(n, verbose=verbose)) for n in SOURCES]
    jobs += [(n, lambda n=n: build_host(n)) for n in HOST_SOURCES]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [(n, pool.submit(job)) for n, job in jobs]
        return {n: f.result() for n, f in futures}


def load(name: str) -> ctypes.PyDLL:
    """The loaded library `name`, built on first use. Loaded as a `PyDLL`:
    its entry points only enqueue a launch and touch no Python object, so
    a call keeps the interpreter lock rather than paying to release and
    take it again."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.PyDLL(str(build(name)))
    return lib
