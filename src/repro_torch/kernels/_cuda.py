"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each source ``csrc/<name>.cu`` becomes ``build/repro_torch_kernels/
<name>-<digest>.so`` under the repository root, where the digest covers the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. Nothing is built when a module is imported: the first
launch builds what it needs, and :func:`build` builds a set of sources in
parallel (one ``nvcc`` each). Every C entry point returns the CUDA error
code of its launch; the Python wrappers raise :class:`KernelError` on any
non-zero code. There is no CPU fallback here: the ops modules take the
plain torch version only for tensors that lie on the CPU.
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

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILDS_FORBIDDEN = False


class KernelError(RuntimeError):
    """A kernel of the port did not build, load or launch."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError("nvcc not found: the port's CUDA kernels are built "
                      "from csrc/ with nvcc on the machine with the card")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def forbid_builds() -> None:
    """Make this process load only kernels that are built already: from
    now on :func:`build` raises :class:`KernelError` for a source whose
    library is missing, instead of running ``nvcc``. A serving shard calls
    it, since the process that started it built what the shards run."""
    global _BUILDS_FORBIDDEN
    _BUILDS_FORBIDDEN = True


def build(names: Iterable[str]) -> Dict[str, Tuple[float, str]]:
    """Build the named sources that are not built yet, all ``nvcc``s at
    once. Returns ``{name: (seconds, ptxas report)}`` for each source built
    by this call; raises :class:`KernelError` if any build fails, or if a
    library is missing in a process that called :func:`forbid_builds`."""
    missing = [n for n in names if not library_path(n).exists()]
    if missing and _BUILDS_FORBIDDEN:
        raise KernelError(f"kernels {missing} are not built under "
                          f"{BUILD_DIR}, and this process may not build "
                          f"them (forbid_builds)")
    if not missing:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in missing:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report: Dict[str, Tuple[float, str]] = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
        report[name] = (secs, log)
    if failed:
        raise KernelError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            try:
                lib = ctypes.CDLL(str(library_path(name)))
            except OSError as err:
                raise KernelError(f"cannot load kernel {name}: {err}") from err
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise :class:`KernelError` for a non-zero CUDA error code."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise KernelError(f"{name} launch failed: CUDA error {code} ({msg})")
