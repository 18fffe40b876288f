"""Build the package's CUDA sources into shared libraries, at first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library of its own with a plain C interface, loaded through
``ctypes``. The first :func:`load` starts one ``nvcc`` per source, all
together, and waits for them all. No PyTorch header is included, so a
build takes seconds. The libraries land in ``_build/`` inside the package
(listed in ``.gitignore``), each named by a hash of its source, the shared
headers (``csrc/*.cuh``) and the flags, so a changed source is rebuilt and
an unchanged one is reused. A missing ``nvcc`` or a failed compile raises
:class:`KernelBuildError`: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ...utils import timing

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``$PATH``, then the
    toolkit's default install directory."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise KernelBuildError(
        "nvcc not found ($CUDA_HOME/bin, $PATH, "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_command(nvcc: str, src: Path, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(out), str(src)]


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return BUILD_DIR / f"libp3d_{src.stem}_{digest.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source whose exact build does not exist yet, one
    ``nvcc`` per source, all started together; return ``{source stem:
    library path}``. Each compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside its library as ``.log``."""
    srcs = sources()
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
    libs = {src.stem: _library_path(src) for src in srcs}
    todo = [src for src in srcs if not libs[src.stem].exists()]
    if not todo:
        return libs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    failures = []
    with timing.build_span("kernels.build",
                           sources=[src.stem for src in todo]):
        jobs = []
        for src in todo:
            out = libs[src.stem]
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(nvcc_command(nvcc, src, tmp),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((src, out, tmp, proc))
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"nvcc exited {proc.returncode} on "
                                f"{src.name}:\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failures:
        raise KernelBuildError("\n".join(failures))
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load the library of ``csrc/<name>.cu`` (once per
    process)."""
    with timing.build_span("kernels.load"):
        libs = build()
        if name not in libs:
            raise KernelBuildError(f"no CUDA source {name}.cu under "
                                   f"{CSRC_DIR}")
        return ctypes.CDLL(str(libs[name]))
