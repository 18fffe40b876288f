"""ctypes loader for the native SEG-Y core (``native/segy_core.cpp``).

Counterpart of ``pseudo_3d_interpolation_tpu/io/native.py``. The port keeps
its own copy of the C++/OpenMP source in the package
(``pseudo_3d_interpolation_torch/native/segy_core.cpp``) and builds it with
``g++`` at first use, with the JAX package's flags (``native/Makefile``),
into the package's ``_build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags, in the way of ``ops/kernels/_build.py``: a
changed source is rebuilt, an unchanged one reused. A compiler without
OpenMP's runtime (no ``libgomp``) builds the same source without
``-fopenmp``, serially (:func:`openmp` says which). When there is no
compiler or both builds fail, :func:`lib` returns None, the codec
decodes with numpy as before, and :func:`build_error` keeps the reasons.

Public surface: :func:`lib` returns the loaded CDLL (its four entry points
bound with the JAX package's ctypes signatures) or None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "native" / "segy_core.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
             "-std=c++17")
# the fallback where the compiler has no OpenMP runtime: the pragmas are
# then ignored and the loops run on one thread
SERIAL_FLAGS = tuple(f for f in CXX_FLAGS if f != "-fopenmp")
BUILD_TIMEOUT_S = 120

_lib = None
_tried = False
_error: str | None = None
_flags: tuple | None = None


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR,
                 flags: tuple = CXX_FLAGS) -> Path:
    """Where the build of ``source`` lands: keyed by its bytes and the
    flags."""
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(source.read_bytes())
    return build_dir / f"libp3dsegy_{digest.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR,
          flags: tuple = CXX_FLAGS) -> Path:
    """Compile ``source`` with ``$CXX`` (default ``g++``) and ``flags``
    into ``build_dir`` unless that exact build exists; return its path.
    Raises ``RuntimeError`` with the compiler's output when it fails or
    is missing."""
    out = library_path(source, build_dir, flags)
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(f"no C++ compiler ({os.environ.get('CXX', 'g++')}"
                           " not on $PATH)")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cxx).name} exited {proc.returncode} on "
                           f"{source.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def bind(cdll: ctypes.CDLL) -> ctypes.CDLL:
    """Set the four entry points' ctypes signatures (the JAX package's)."""
    cdll.ibm2ieee_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    cdll.ieee2ibm_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    cdll.decode_traces.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p]
    cdll.decode_traces.restype = ctypes.c_int
    cdll.header_column.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p]
    cdll.header_column.restype = ctypes.c_int
    return cdll


def lib():
    """Load (building if needed) the native library once per process, with
    OpenMP or else without; None when neither builds and loads
    (:func:`build_error` says why)."""
    global _lib, _tried, _error, _flags
    if _lib is not None or _tried:
        return _lib
    _tried = True
    errors = []
    for flags in (CXX_FLAGS, SERIAL_FLAGS):
        try:
            _lib = bind(ctypes.CDLL(str(build(flags=flags))))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            errors.append(f"{type(e).__name__}: {e}")
            continue
        _flags = flags
        return _lib
    _error = "\n".join(errors)
    return None


def build_error() -> str | None:
    """Why :func:`lib` is None (the compilers' output, or the load
    errors); None while it loads or before it was tried."""
    return _error


def openmp() -> bool | None:
    """Whether the loaded library was built with OpenMP (None when none
    is loaded)."""
    return None if _flags is None else "-fopenmp" in _flags
