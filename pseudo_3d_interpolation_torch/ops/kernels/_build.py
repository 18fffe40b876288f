"""Build the package's CUDA sources into one shared library, at first use.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded through ``ctypes``.
No PyTorch header is included, so a build takes seconds. The library lands
in ``_build/`` inside the package (listed in ``.gitignore``), named by a hash
of the sources and flags, so a changed source is rebuilt and an unchanged
one is reused. A missing ``nvcc`` or a failed compile raises
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


def nvcc_command(nvcc: str, srcs, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, srcs)]


def build() -> Path:
    """Compile the sources unless this exact build exists; return the
    library's path. The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it as ``.log``."""
    srcs = sources()
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libp3d_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(nvcc, srcs, tmp), capture_output=True,
                          text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc exited {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed and load the kernels' library (once per process)."""
    return ctypes.CDLL(str(build()))
