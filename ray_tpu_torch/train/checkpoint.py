"""Checkpoint handle: a directory plus a (possibly remote) filesystem.

The port's copy of ``ray_tpu/train/checkpoint.py``.

Reference: python/ray/train/_checkpoint.py:56 — Checkpoint is a location
pointer, not a blob; frameworks (orbax, flax serialization, msgpack) write
the actual files
(here ``dist_checkpoint`` on ``torch.distributed.checkpoint``). fsspec gives S3/GCS transparently.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import uuid
from typing import Iterator, Optional

import fsspec


class Checkpoint:
    """A reference to a checkpoint directory on some filesystem."""

    def __init__(self, path: str, filesystem: Optional[fsspec.AbstractFileSystem] = None):
        if filesystem is None:
            filesystem, path = _resolve(path)
        self.path = path
        self.filesystem = filesystem

    # -------------------------------------------------------- constructors
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(os.path.abspath(path), fsspec.filesystem("file"))

    # ------------------------------------------------------------- access
    def to_directory(self, path: Optional[str] = None) -> str:
        """Materialize the checkpoint into a local directory and return it."""
        if path is None:
            path = os.path.join(
                tempfile.gettempdir(), f"rtpt_ckpt_{uuid.uuid4().hex[:8]}")
        os.makedirs(path, exist_ok=True)
        if _is_local(self.filesystem):
            if os.path.abspath(self.path) != os.path.abspath(path):
                shutil.copytree(self.path, path, dirs_exist_ok=True)
        else:
            self.filesystem.get(self.path.rstrip("/") + "/", path, recursive=True)
        return path

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        """Local dirs are yielded in place (zero copy); remote ones are
        downloaded to a temp dir that is cleaned up on exit."""
        if _is_local(self.filesystem):
            yield self.path
        else:
            tmp = self.to_directory()
            try:
                yield tmp
            finally:
                shutil.rmtree(tmp, ignore_errors=True)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __reduce__(self):
        proto = getattr(self.filesystem, "protocol", "file")
        if isinstance(proto, (tuple, list)):
            proto = proto[0]
        uri = self.path if proto in ("file", "local") else f"{proto}://{self.path}"
        return (Checkpoint, (uri,))


def _is_local(fs) -> bool:
    proto = getattr(fs, "protocol", "file")
    if isinstance(proto, (tuple, list)):
        return "file" in proto or "local" in proto
    return proto in ("file", "local")


def _resolve(uri: str):
    if "://" in uri:
        fs, _, paths = fsspec.get_fs_token_paths(uri)
        return fs, paths[0] if isinstance(paths, list) else paths
    return fsspec.filesystem("file"), os.path.abspath(uri)
