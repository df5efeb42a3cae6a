"""Builder and loader for the hand-written CUDA kernels.

Every ``ray_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
into an object file, all sources at once in parallel, and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``. The library is named by a hash of the sources and flags and
lives under ``ray_tpu_torch/_build/`` (git-ignored), so the first call
that needs a kernel builds it and later calls reuse it. A file lock
serialises builds across threads and processes.

No PyTorch headers are included: the kernels take raw pointers and the
CUDA stream from the Python wrappers, which keeps a build to seconds.
The CPU tests never reach this module's build: the wrappers run their
plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "-lineinfo"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build took in this process (0.0 when the library was
# found already built); chip_smoke.py prints it
last_build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (see csrc/*.cu); every kernel
# entry returns the cudaError_t of its launch, rtt_error_string its name
_SIGNATURES = {
    "rtt_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _F, _P],
    "rtt_flash_fwd_sm90": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _F, _P],
    "rtt_flash_fwd_sm90_d256": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _F, _P],
    "rtt_flash_fwd_tf32x3": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _F, _P],
    "rtt_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _F, _P],
    "rtt_flash_bwd_dq_sm90": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _F, _P],
    "rtt_flash_bwd_dq_tf32x3": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _I, _F, _P],
    "rtt_flash_bwd_dq_sm90_d256": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _F, _P],
    "rtt_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I, _F, _P],
    "rtt_flash_bwd_dkv_sm90": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _F, _P],
    "rtt_flash_bwd_dkv_sm90_d256": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _F, _P],
    "rtt_flash_bwd_dkv_tf32x3": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _I, _F, _P],
    "rtt_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "rtt_paged_merge": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _I, _P],
    "rtt_error_string": [_I],
}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every kernel source, header and compiler flag: the name
    of the library those sources build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh"))):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(Path(os.environ[env]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of ray_tpu_torch are "
        "built from source at first use and need the CUDA toolkit")


def _compile(nvcc: str, out: Path) -> str:
    """Compile every source in parallel, then link; returns the log."""
    tmp = out.parent / f"{out.stem}.tmp{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, obj, p in procs:
        text, _ = p.communicate()
        log.append(f"$ {' '.join(cmd)}\n{text}")
        if p.returncode != 0:
            failed.append(cmd[-3])
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(log))
    link = [nvcc, "-shared", "-o", str(tmp / out.name),
            *[str(obj) for _, obj, _ in procs]]
    p = subprocess.run(link, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True)
    log.append(f"$ {' '.join(link)}\n{p.stdout}")
    if p.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    os.replace(tmp / out.name, out)   # atomic publish
    shutil.rmtree(tmp, ignore_errors=True)
    return "\n".join(log)


def library_path() -> Path:
    return BUILD_DIR / f"librtt_kernels_{source_hash()}.so"


def load() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has no
    library yet. Thread- and process-safe."""
    global _lib, last_build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "build.lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                if not out.exists():
                    t0 = time.perf_counter()
                    log = _compile(find_nvcc(), out)
                    last_build_seconds = time.perf_counter() - t0
                    (BUILD_DIR / "build.log").write_text(log)
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rtt_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if err != 0:
        msg = lib.rtt_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
