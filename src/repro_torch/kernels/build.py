"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/<name>-<digest>.so`` at the repository root (a
directory ``.gitignore`` lists), for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<digest>.so csrc/<name>.cu

Sources may include the shared headers ``csrc/*.cuh`` (``mma_sm90.cuh``:
``cp.async``, ``ldmatrix`` and ``mma.sync`` primitives).  The digest covers
the source, every header and the flags, so an edited source or header is
never served a stale library.  ``ptxas -v`` output (registers, shared memory,
spills per kernel) is kept beside the library as ``<name>-<digest>.log``.
Nothing is compiled when a module is imported: the first call that needs a
kernel builds it, and :func:`build_all` starts one ``nvcc`` per source at
once.  Only sources in this package are compiled.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the CUDA kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where ``<name>.cu`` builds to: named by a digest of the source, every
    ``csrc/*.cuh`` header in sorted order, and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _tmp(out: Path) -> Path:
    return out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")


def nvcc_command(name: str, out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named kernel (default: all) that is not built yet, one
    ``nvcc`` per source, all started together.  Returns name -> library path
    and raises with the compiler's output if any build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    failed = []
    with contextlib.ExitStack() as stack:  # closes every log and waits for every nvcc
        procs = {}
        for n in names:
            if paths[n].exists():
                continue
            log = stack.enter_context(open(paths[n].with_suffix(".log"), "w"))
            cmd = nvcc_command(n, _tmp(paths[n]))
            procs[n] = stack.enter_context(
                subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            )
        for n, proc in procs.items():
            tmp = _tmp(paths[n])
            if proc.wait() == 0:
                os.replace(tmp, paths[n])  # atomic: a concurrent loader never sees half a file
            else:
                tmp.unlink(missing_ok=True)
                failed.append(
                    f"{n}: nvcc exited {proc.returncode}\n"
                    + paths[n].with_suffix(".log").read_text()
                )
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def ptxas_report(name: str) -> str:
    """What ``nvcc -Xptxas -v`` printed for the built kernel: registers,
    shared memory, stack frame, spill stores and loads per function."""
    return library_path(name).with_suffix(".log").read_text().strip()


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return ctypes.CDLL(str(build_all([name])[name]))
