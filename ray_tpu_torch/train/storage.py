"""Storage layout for experiments/trials/checkpoints.

The port's copy of ``ray_tpu/train/storage.py``; the manifest keeps the
reference's name, so either package validates the other's checkpoints.

Reference: python/ray/train/_internal/storage.py:352 (StorageContext).
Layout: <storage_path>/<experiment_name>/<trial_name>/checkpoint_NNNNNN/.
Local paths use the local fs; remote URIs (s3://, gs://) go through fsspec.
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
import uuid
from typing import Optional

import fsspec

from ray_tpu_torch.train.checkpoint import Checkpoint, _is_local

# Commit marker for crash-safe checkpoint persistence: written LAST into
# the staged checkpoint dir, listing every file and its size. A dir
# without a valid manifest whose sizes match is torn (the persisting
# worker died mid-copy) and resume falls back to the previous tracked
# checkpoint. Checkpoints written by older versions have no manifest and
# are trusted as-is.
MANIFEST_NAME = ".rtpu_ckpt_manifest.json"


def _build_manifest(dirpath: str, index: int) -> dict:
    files = {}
    for base, _, names in os.walk(dirpath):
        for name in names:
            if base == dirpath and name == MANIFEST_NAME:
                continue
            full = os.path.join(base, name)
            rel = os.path.relpath(full, dirpath)
            files[rel] = os.path.getsize(full)
    return {"index": index, "files": files}


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def validate_checkpoint_dir(path: str, fs=None) -> bool:
    """Is a persisted checkpoint dir consistent (fully committed)?

    True for manifest-less dirs (legacy / foreign checkpoints — nothing
    to check against); False when the dir is missing, the manifest is
    unreadable, or any listed file is missing or size-mismatched."""
    if fs is not None and not _is_local(fs):
        try:
            if not fs.exists(path):
                return False
            mpath = path.rstrip("/") + "/" + MANIFEST_NAME
            if not fs.exists(mpath):
                return True
            with fs.open(mpath, "r") as f:
                manifest = json.load(f)
            for rel, size in manifest.get("files", {}).items():
                fpath = path.rstrip("/") + "/" + rel
                if not fs.exists(fpath) or fs.info(fpath).get("size") != size:
                    return False
            return True
        except (OSError, ValueError, KeyError):
            return False
    if not os.path.isdir(path):
        return False
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return True
    try:
        with open(mpath, encoding="utf-8") as f:
            manifest = json.load(f)
        files = manifest.get("files")
        if not isinstance(files, dict):
            return False
        for rel, size in files.items():
            full = os.path.join(path, rel)
            if not os.path.isfile(full) or os.path.getsize(full) != size:
                return False
        return True
    except (OSError, ValueError):
        return False


class StorageContext:
    def __init__(self, storage_path: str, experiment_name: Optional[str] = None,
                 trial_name: Optional[str] = None):
        if "://" in storage_path:
            self.fs, _, paths = fsspec.get_fs_token_paths(storage_path)
            self.root = paths[0] if isinstance(paths, list) else paths
        else:
            self.fs = fsspec.filesystem("file")
            self.root = os.path.abspath(storage_path)
        if experiment_name is None:
            stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
            experiment_name = f"rtpt_experiment_{stamp}"
        self.experiment_name = experiment_name
        self.trial_name = trial_name or f"trial_{uuid.uuid4().hex[:8]}"

    # ------------------------------------------------------------- paths
    @property
    def experiment_path(self) -> str:
        return os.path.join(self.root, self.experiment_name)

    @property
    def trial_path(self) -> str:
        return os.path.join(self.experiment_path, self.trial_name)

    def checkpoint_path(self, index: int) -> str:
        return os.path.join(self.trial_path, f"checkpoint_{index:06d}")

    def ensure_trial_dir(self):
        self.fs.makedirs(self.trial_path, exist_ok=True)

    # --------------------------------------------------------- persisting
    def persist_checkpoint_dir(self, local_dir: str, index: int) -> Checkpoint:
        """Upload/copy a locally-written checkpoint dir into the trial dir.

        Crash-safe on local filesystems: the dir is staged under a
        hidden ``.tmp-*`` sibling, a manifest (file list + sizes) is
        fsynced into it, and the stage is committed with an atomic
        rename + parent-dir fsync — a worker dying mid-persist leaves
        only an invisible stage, never a torn ``checkpoint_NNNNNN``.
        Deterministic elastic replay may re-persist an index that
        already exists (an orphan written past the resume point); the
        replacement wins. On object stores rename isn't atomic; the
        manifest is uploaded last as the commit marker and resume
        validates it."""
        dest = self.checkpoint_path(index)
        if _is_local(self.fs):
            if os.path.abspath(local_dir) == os.path.abspath(dest):
                # written in place: just commit the manifest
                self._write_manifest(dest, index)
                return Checkpoint(dest, self.fs)
            parent = os.path.dirname(dest)
            os.makedirs(parent, exist_ok=True)
            tmp = os.path.join(
                parent, f".tmp-{os.path.basename(dest)}-{uuid.uuid4().hex[:8]}")
            shutil.copytree(local_dir, tmp)
            self._write_manifest(tmp, index)
            if os.path.exists(dest):
                shutil.rmtree(dest)
            os.rename(tmp, dest)
            _fsync_dir(parent)
        else:
            self.fs.put(local_dir.rstrip("/") + "/", dest, recursive=True)
            manifest = {"index": index, "files": {}}
            for base, _, names in os.walk(local_dir):
                for name in names:
                    full = os.path.join(base, name)
                    rel = os.path.relpath(full, local_dir)
                    manifest["files"][rel] = os.path.getsize(full)
            with self.fs.open(
                    dest.rstrip("/") + "/" + MANIFEST_NAME, "w") as f:
                f.write(json.dumps(manifest))
        return Checkpoint(dest, self.fs)

    @staticmethod
    def _write_manifest(dirpath: str, index: int) -> None:
        manifest = _build_manifest(dirpath, index)
        mpath = os.path.join(dirpath, MANIFEST_NAME)
        tmp = mpath + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, mpath)
        _fsync_dir(dirpath)

    def delete_checkpoint(self, checkpoint: Checkpoint):
        try:
            checkpoint.filesystem.rm(checkpoint.path, recursive=True)
        except FileNotFoundError:
            pass

    def for_trial(self, trial_name: str) -> "StorageContext":
        s = StorageContext.__new__(StorageContext)
        s.fs, s.root = self.fs, self.root
        s.experiment_name, s.trial_name = self.experiment_name, trial_name
        return s
