"""Build and load the port's hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, keyed
by a hash of the source and the flags, under ``build/repro_torch/`` at
the repository root (listed in ``.gitignore``), and loaded with
``ctypes``. A library is built at first use; ``build_all`` starts one
``nvcc`` per source at once, so a cold start costs one compile, not the
sum. A failed build raises ``KernelBuildError`` with the compiler's
output — there is no fallback.

Every C entry point takes ``void*`` pointers and a ``void*`` stream
(``ctypes.c_void_p``) and returns ``cudaGetLastError()`` after its
launch; ``check`` raises ``KernelLaunchError`` when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("conv3d", "bn_act", "halo_pack")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp-{os.getpid()}-{threading.get_ident()}")
    log = out.with_suffix(".log")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise KernelBuildError(f"cannot run {cmd[0]}: {e}") from e
    return tmp, log, proc


def _finish(name: str, tmp: Path, log: Path,
            proc: subprocess.Popen) -> None:
    output, _ = proc.communicate()
    log.write_text(output)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{output}")
    os.replace(tmp, library_path(name))  # atomic: no reader sees half a file


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build every missing library, one ``nvcc`` per source, all
    started together. Returns ``{name: seconds}`` (0.0 when the
    library was already built)."""
    with _LOCK:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in names
                   if not library_path(n).exists()}
        secs = {n: 0.0 for n in names}
        for n, (tmp, log, proc) in started.items():
            _finish(n, tmp, log, proc)
            secs[n] = time.perf_counter() - t0
        return secs


def build_log(name: str) -> str:
    """The compiler output of the current build of ``name`` (register
    and shared-memory use from ``ptxas -v``), or '' when not built
    here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if
    needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise KernelLaunchError(f"{what}: CUDA error {err}")


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock: the shards of a
    spatial run launch from threads of their own."""
    with _COUNT_LOCK:
        wrapper.launches += 1


__all__ = ["KernelBuildError", "KernelLaunchError", "build_all", "build_log",
           "check", "count_launch", "library_path", "load", "nvcc_path"]
