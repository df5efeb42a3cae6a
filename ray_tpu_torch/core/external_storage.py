"""Spill storage backends: local disk (mmap fast path) or any fsspec
URI.

Reference: python/ray/_private/external_storage.py:451 — the reference
spills to the filesystem or to S3 (smart_open); here the same split is
local-path vs fsspec URI (s3://, gs://, memory://, file://...), chosen
by ``RTPU_SPILL_DIR``. Local spill files are mmap'd on read (large
tensors stay file-backed until touched); URI spills read through
fsspec.
"""

from __future__ import annotations

import os
from typing import Tuple


def is_uri(path: str) -> bool:
    return "://" in path


def _fs_and_path(uri: str):
    import fsspec

    fs, _, paths = fsspec.get_fs_token_paths(uri)
    return fs, paths[0]


def _join_uri(base: str, name: str) -> str:
    """URI join that survives bare-root bases: 'memory://'.rstrip('/')
    would collapse to 'memory:' and silently stop being a URI."""
    return base + name if base.endswith("://") \
        else base.rstrip("/") + "/" + name


def spill_dir_for(base: str, session: str) -> str:
    """Session-scoped spill location under the configured base."""
    if is_uri(base):
        return _join_uri(base, session)
    return os.path.join(base, session)


def write(spill_dir: str, name: str, view) -> Tuple[str, int]:
    """Write one spilled payload; returns (path_or_uri, size)."""
    if is_uri(spill_dir):
        uri = _join_uri(spill_dir, name)
        fs, p = _fs_and_path(uri)
        fs.makedirs(os.path.dirname(p), exist_ok=True)
        with fs.open(p, "wb") as f:
            # buffer-protocol write: no full bytes() copy of a payload
            # being spilled precisely because memory is tight
            f.write(view)
        return uri, view.nbytes
    os.makedirs(spill_dir, exist_ok=True)
    path = os.path.join(spill_dir, name)
    with open(path, "wb") as f:
        f.write(view)
    return path, view.nbytes


def read_buffer(path: str):
    """The spilled payload as a buffer. Local files mmap (file-backed
    until touched); URIs read through fsspec."""
    if is_uri(path):
        fs, p = _fs_and_path(path)
        with fs.open(p, "rb") as f:
            return f.read()
    import mmap as _mmap

    with open(path, "rb") as f:
        return _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)


def read_range(path: str, offset: int, length: int) -> bytes:
    if is_uri(path):
        fs, p = _fs_and_path(path)
        with fs.open(p, "rb") as f:
            f.seek(offset)
            return f.read(length)
    with open(path, "rb") as f:
        f.seek(offset)
        return f.read(length)


def size(path: str):
    try:
        if is_uri(path):
            fs, p = _fs_and_path(path)
            return fs.size(p)
        return os.path.getsize(path)
    except Exception:  # noqa: BLE001
        return None


def corrupt(path: str, nbytes: int = 64) -> bool:
    """Overwrite the head of a spill file with garbage in place (fault
    injection: a torn write / bad sector stand-in). The file keeps its
    size so only content validation — not existence checks — can tell.
    Returns False when the file is missing or the backend can't seek."""
    junk = b"\xde\xad\xbe\xef" * (nbytes // 4 + 1)
    try:
        if is_uri(path):
            fs, p = _fs_and_path(path)
            data = bytearray(fs.cat_file(p))
            n = min(len(data), nbytes)
            data[:n] = junk[:n]
            with fs.open(p, "wb") as f:
                f.write(bytes(data))
        else:
            with open(path, "r+b") as f:
                end = f.seek(0, 2)
                f.seek(0)
                f.write(junk[:min(end, nbytes)])
        return True
    except Exception:  # noqa: BLE001
        return False


def delete(path: str):
    try:
        if is_uri(path):
            fs, p = _fs_and_path(path)
            fs.rm(p)
        else:
            os.remove(path)
    # rtpu-lint: disable=L4 — best-effort delete of a spill file that may
    # already be gone; fsspec backends raise backend-specific types, not
    # a common base
    except Exception:  # noqa: BLE001
        pass


def cleanup_dir(spill_dir: str):
    """Remove a session's whole spill location (local tree or remote
    prefix) — shutdown must not leak spilled objects into the bucket."""
    try:
        if is_uri(spill_dir):
            fs, p = _fs_and_path(spill_dir)
            fs.rm(p, recursive=True)
        else:
            import shutil

            shutil.rmtree(spill_dir, ignore_errors=True)
    # rtpu-lint: disable=L4 — shutdown cleanup: a missing prefix or a
    # backend-specific fsspec error must not fail the teardown
    except Exception:  # noqa: BLE001
        pass
