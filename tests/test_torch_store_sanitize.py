"""TSAN/ASAN hammer for the port's C++ shm store (``_shm_store.cc``).

``tests/test_store_sanitize.py``'s program on the port: the instrumented
library (``ensure_built(sanitize=...)``, built into
``ray_tpu_torch/_build/`` under a name of its source's hash and the
sanitizer) is loaded into subprocesses through ``RTPU_STORE_LIB`` with
the sanitizer runtime ``LD_PRELOAD``ed, and a copy of
``tests/store_hammer.py`` with ``ray_tpu`` read as ``ray_tpu_torch`` (its
channel descriptor file under ``tempfile.gettempdir()``) drives
concurrent create/seal/get/release/delete/eviction plus a channel seqno
ping-pong across the shared arena, at the reference's size (3 workers
of 400 ops, 200 channel messages). Any sanitizer report fails the run.
Each test skips, as the reference's does, where ``g++`` has no runtime
for its sanitizer.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
import uuid
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_HAMMER = ROOT / "tests" / "store_hammer.py"


def _san_runtime(libname: str) -> str:
    out = subprocess.run(["g++", f"-print-file-name={libname}"],
                         capture_output=True, text=True).stdout.strip()
    return out if out and os.path.sep in out else ""


def _port_hammer(tmp_path) -> Path:
    src = re.sub(r"\bray_tpu\b", "ray_tpu_torch", _HAMMER.read_text())
    old = 'f"/tmp/{name.strip(\'/\')}.chan"'
    assert old in src
    src = src.replace(old, f"os.path.join({tempfile.gettempdir()!r}, "
                           f"name.strip('/') + '.chan')")
    path = tmp_path / "store_hammer_port.py"
    path.write_text(src)
    return path


def _run_hammer(tmp_path, sanitize: str, preload: str, opts_var: str,
                opts: str):
    from ray_tpu_torch.core.object_store.build import ensure_built

    lib = ensure_built(sanitize)
    assert os.path.basename(lib).startswith(f"_shm_store_{sanitize}_")
    env = dict(os.environ)
    env.update({
        "RTPU_STORE_LIB": lib,
        "LD_PRELOAD": preload,
        opts_var: opts,
        "PYTHONPATH": os.pathsep.join(filter(None, (
            str(ROOT), os.environ.get("PYTHONPATH")))),
    })
    name = f"/rtpt_san_{sanitize}_{uuid.uuid4().hex[:8]}"
    proc = subprocess.run(
        [sys.executable, str(_port_hammer(tmp_path)), "driver", name, "3",
         "400"], env=env, capture_output=True, text=True, timeout=560)
    sys.stderr.write(proc.stderr[-4000:])
    assert proc.returncode == 0, \
        f"hammer rc={proc.returncode}\n{proc.stderr[-4000:]}"
    assert "HAMMER_OK" in proc.stdout
    assert "WARNING: ThreadSanitizer" not in proc.stderr
    assert "ERROR: AddressSanitizer" not in proc.stderr


def test_store_hammer_asan(tmp_path):
    rt = _san_runtime("libasan.so")
    if not rt:
        pytest.skip("libasan not available")
    _run_hammer(
        tmp_path, "address", rt, "ASAN_OPTIONS",
        # leak detection off: CPython itself 'leaks' interned objects at
        # exit; we are after heap corruption in the store, not that
        "detect_leaks=0:abort_on_error=0:exitcode=66")


def test_store_hammer_tsan(tmp_path):
    rt = _san_runtime("libtsan.so")
    if not rt:
        pytest.skip("libtsan not available")
    _run_hammer(
        tmp_path, "thread", rt, "TSAN_OPTIONS",
        # die_after_fork=0: the driver subprocess-spawns its workers;
        # report_signal_unsafe off for CPython's signal handling
        "halt_on_error=1:exitcode=66:die_after_fork=0"
        ":report_signal_unsafe=0")


def test_sanitizer_builds_are_named_by_hash_and_sanitizer():
    """Each build of the store has a name of its own: the plain one,
    and one a sanitizer, each carrying the hash of the source and its
    flags; none is the reference's name beside the source."""
    from ray_tpu_torch.core.object_store import build

    names = {s: os.path.basename(build.library_path(s))
             for s in ("", "address", "thread")}
    assert len(set(names.values())) == 3
    assert names[""].startswith("_shm_store_")
    for s in ("address", "thread"):
        assert re.fullmatch(rf"_shm_store_{s}_[0-9a-f]{{16}}\.so", names[s])
    assert all(os.path.dirname(build.library_path(s)) == build.BUILD_DIR
               for s in names)
