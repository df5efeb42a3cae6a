"""Compile the shm store C++ extension on first use.

The library is built from ``_shm_store.cc`` (a copy of ``ray_tpu``'s
store) by ``g++`` into ``ray_tpu_torch/_build/`` (git-ignored), named by
a hash of the source and flags, so a checkout never ships a binary and
an edited source never loads a stale one. Concurrent first uses (several
processes starting runtimes at once) each compile to a private
temporary file and rename it into place, which is atomic.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

from ray_tpu_torch.util.debug_lock import make_lock

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "_shm_store.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
_FLAGS = ["-std=c++17", "-shared", "-fPIC", "-O2"]
_lock = make_lock("object_store.build._lock")


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"_shm_store_{h.hexdigest()[:16]}.so")


def ensure_built(force: bool = False) -> str:
    """Build the store library if missing; return its path.

    ``force`` recompiles even when the library exists: the loader uses
    it when a cached .so turns out to be ABI-incompatible with the host
    (e.g. a build directory copied from another machine)."""
    lib = library_path()
    with _lock:
        if not force and os.path.exists(lib):
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = lib + f".tmp{os.getpid()}"
        subprocess.run(["g++"] + _FLAGS + ["-o", tmp, _SRC, "-lpthread",
                                           "-lrt"],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
        return lib
