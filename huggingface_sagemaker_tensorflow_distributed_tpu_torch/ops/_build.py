"""Builds the port's CUDA sources (``csrc/*.cu``) with ``nvcc``, and its
C++ host library (``csrc/host/*.cc``) with ``g++``, into shared libraries
with a plain C interface, and loads them with ``ctypes``.

A library is built at first use into ``build/kernels/`` beside the
package (a directory the repository ignores), named by a hash of its
source, every header in ``csrc/`` (``*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
``ptxas`` reports each kernel's registers, spills and static shared
memory (``-Xptxas -v``) into ``<library>.log`` beside the library. A
failed build raises; nothing falls back.

The host library (:func:`load_host`: the WordPiece core and the data
loader's primitives, ``data/native.py``) builds the same way into
``build/host/``, named by a hash of its sources and flags. The port never
writes into the JAX package's ``native/`` directory and never loads a
library it finds there.

Each build and each process's first load of a library reaches the
installed compile trackers (``obs/watchdog.py``) as one observation named
``/hstd/compile/<nvcc|g++|load>/<library>`` with its wall seconds; builds
that run in parallel each report their own.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.watchdog import (
    report_compile,
)

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# every kernel source of the package (``csrc/<name>.cu``)
SOURCES = ("paged_attention", "flash_attention", "vocab_ce")
HOST_DIR = CSRC_DIR / "host"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
HOST_SOURCES = ("wordpiece.cc", "dataloader.cc")
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
# -split-compile=0: the optimizer's passes run over the kernels in parallel
# on every core (the same registers and spills, half the build time)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=0")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the "
            "CUDA kernels are built from source at first use")
    return path


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: named by a
    hash of that source, of every ``csrc/*.cuh`` (any of them may be
    included) and of the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> Path:
    """``nvcc``'s report (ptxas: registers, spills, static shared memory
    per kernel) of the build of ``library_path(name)``."""
    return library_path(name).with_suffix(".log")


def _finish(proc: subprocess.Popen, t0: float) -> tuple[str, float]:
    """``proc``'s stderr and its wall seconds since ``t0``, once it exits."""
    _, stderr = proc.communicate()
    return stderr, time.perf_counter() - t0


def build(*names: str) -> None:
    """Build the missing libraries of ``csrc/<name>.cu``, one ``nvcc`` per
    source, all started together; each reports its own seconds."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, out, tmp, proc, t0))
    if not jobs:
        return
    # one thread a job drains its pipes, so each build's seconds end when
    # that nvcc exits, not when an earlier one in the list does
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(lambda job: _finish(job[3], job[4]), jobs))
    failed = []
    for (name, out, tmp, proc, _), (stderr, secs) in zip(jobs, done):
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build csrc/{name}.cu (exit "
                          f"{proc.returncode}):\n{stderr}")
        else:
            out.with_suffix(".log").write_text(stderr)
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
            report_compile(f"/hstd/compile/nvcc/{name}", secs)
    if failed:
        raise RuntimeError("\n".join(failed))


def _load_timed(path: Path, name: str) -> ctypes.CDLL:
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(path))
    report_compile(f"/hstd/compile/load/{name}", time.perf_counter() - t0)
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    build(name)
    return _load_timed(library_path(name), name)


def host_library_path() -> Path:
    """Where the host library built from ``csrc/host/*.cc`` lives: named by
    a hash of those sources and of the flags."""
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for src in HOST_SOURCES:
        digest.update(src.encode() + (HOST_DIR / src).read_bytes())
    return HOST_BUILD_DIR / f"libhstd_host-{digest.hexdigest()[:16]}.so"


def build_host() -> Path:
    """Build the host library with ``g++`` if it is missing; returns its
    path. Raises with the compiler's errors when the build fails or no
    ``g++`` is found."""
    out = host_library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the host library "
                           "(csrc/host/*.cc) is built from source at first use")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp),
                           *(str(HOST_DIR / s) for s in HOST_SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build csrc/host (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    report_compile("/hstd/compile/g++/host", time.perf_counter() - t0)
    return out


@functools.lru_cache(maxsize=None)
def load_host() -> ctypes.CDLL:
    """Build the host library if it is missing, then load it."""
    return _load_timed(build_host(), "host")
