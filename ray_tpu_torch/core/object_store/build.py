"""Compile the shm store C++ extension on first use.

The library is built from ``_shm_store.cc`` (a copy of ``ray_tpu``'s
store) by ``g++`` into ``ray_tpu_torch/_build/`` (git-ignored), named by
a hash of the source and flags, so a checkout never ships a binary and
an edited source never loads a stale one. Concurrent first uses (several
processes starting runtimes at once) each compile to a private
temporary file and rename it into place, which is atomic.

``python -m ray_tpu_torch.core.object_store.build --sanitize=thread``
(or ``address``) builds a sanitizer-instrumented variant beside the
normal one, with the reference's flags; the stress harness
(``tests/test_torch_store_sanitize.py``) loads it through
``RTPU_STORE_LIB`` (reference practice: TSAN/ASAN CI jobs over the
plasma store).
"""

from __future__ import annotations

import hashlib
import os
import subprocess

from ray_tpu_torch.util.debug_lock import make_lock

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "_shm_store.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
_BASE = ["-std=c++17", "-shared", "-fPIC"]
_SAN_FLAGS = {
    "thread": ["-fsanitize=thread", "-O1", "-g"],
    "address": ["-fsanitize=address", "-O1", "-g",
                "-fno-omit-frame-pointer"],
}
_lock = make_lock("object_store.build._lock")


def _flags(sanitize: str) -> list:
    return _BASE + (_SAN_FLAGS[sanitize] if sanitize else ["-O2"])


def library_path(sanitize: str = "") -> str:
    """Where the library for the current source and flags lives;
    ``sanitize`` ("thread" or "address") names the instrumented one."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_flags(sanitize)).encode())
    tag = f"_{sanitize}" if sanitize else ""
    return os.path.join(BUILD_DIR,
                        f"_shm_store{tag}_{h.hexdigest()[:16]}.so")


def ensure_built(sanitize: str = "", force: bool = False) -> str:
    """Build the store library if missing; return its path.

    ``sanitize`` in {"thread", "address"} builds/returns the
    instrumented variant (a separate .so — normal users never pay the
    sanitizer tax). ``force`` recompiles even when the library exists:
    the loader uses it when a cached .so turns out to be ABI-incompatible
    with the host (e.g. a build directory copied from another machine)."""
    lib = library_path(sanitize)
    with _lock:
        if not force and os.path.exists(lib):
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = lib + f".tmp{os.getpid()}"
        subprocess.run(["g++"] + _flags(sanitize)
                       + ["-o", tmp, _SRC, "-lpthread", "-lrt"],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
        return lib


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--sanitize", choices=["thread", "address", ""],
                    default="")
    print(ensure_built(ap.parse_args().sanitize))
