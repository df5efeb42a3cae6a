"""Resource model with GPUs as a first-class resource.

Resources are fixed-point scalar maps
(src/ray/common/scheduling/cluster_resource_data.h, fixed_point.h in the
reference framework). A node owns a ``GpuSet``: the ``"GPU"`` resource
counts its cards and allocation binds concrete device ids, which a GPU
actor's worker receives as ``CUDA_VISIBLE_DEVICES`` (the port's
counterpart of ``ray_tpu``'s TPU slice topology and ``TPU_VISIBLE_CHIPS``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

# Fixed-point arithmetic: resources are stored as integers scaled by 1e4
# (the reference uses the same trick to avoid float drift in admission
# control — src/ray/common/scheduling/fixed_point.h).
RESOLUTION = 10_000


def to_fixed(v: float) -> int:
    return int(round(v * RESOLUTION))


def from_fixed(v: int) -> float:
    return v / RESOLUTION


class ResourceSet:
    """A non-negative resource vector keyed by resource name."""

    __slots__ = ("_r",)

    def __init__(self, resources: Optional[Dict[str, float]] = None):
        self._r: Dict[str, int] = {}
        if resources:
            for k, v in resources.items():
                fv = to_fixed(v)
                if fv < 0:
                    raise ValueError(f"negative resource {k}={v}")
                if fv:
                    self._r[k] = fv

    @classmethod
    def _from_fixed_map(cls, m: Dict[str, int]) -> "ResourceSet":
        rs = cls()
        rs._r = {k: v for k, v in m.items() if v}
        return rs

    def get(self, name: str) -> float:
        return from_fixed(self._r.get(name, 0))

    def to_dict(self) -> Dict[str, float]:
        return {k: from_fixed(v) for k, v in self._r.items()}

    def is_subset_of(self, other: "ResourceSet") -> bool:
        return all(other._r.get(k, 0) >= v for k, v in self._r.items())

    def __add__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._r)
        for k, v in other._r.items():
            out[k] = out.get(k, 0) + v
        return ResourceSet._from_fixed_map(out)

    def subtract_unchecked(self, other: "ResourceSet") -> "ResourceSet":
        """Subtraction that may go negative (oversubscription debt while a
        blocked worker resumes — the reference raylet does the same when
        workers blocked in ray.get are released and re-admitted)."""
        out = dict(self._r)
        for k, v in other._r.items():
            out[k] = out.get(k, 0) - v
        return ResourceSet._from_fixed_map(out)

    def __sub__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._r)
        for k, v in other._r.items():
            nv = out.get(k, 0) - v
            if nv < 0:
                raise ValueError(
                    f"resource {k} would go negative ({from_fixed(nv)})"
                )
            out[k] = nv
        return ResourceSet._from_fixed_map(out)

    def __bool__(self):
        return bool(self._r)

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and self._r == other._r

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"


# --------------------------------------------------------------------------
# GPUs
# --------------------------------------------------------------------------


class GpuSet:
    """The node's GPUs: a list of device ids, each bound to at most one
    actor or bundle at a time.

    The reference's TPU slice allocates ICI-contiguous rectangles of a
    chip grid (``TpuSliceTopology``). GPUs of one node are joined all to
    all (NVLink or PCIe), so any ``n`` free ids serve a gang and
    ``allocate`` needs no contiguity search; ``STRICT_PACK`` keeps its
    meaning, one node. An id is the string a child process's
    ``CUDA_VISIBLE_DEVICES`` names the card by (an index, or a UUID when
    the driver's own variable lists UUIDs).
    """

    def __init__(self, ids):
        """``ids``: a count (ids ``0..n-1``) or the ids themselves."""
        if isinstance(ids, int):
            ids = range(ids)
        self.ids: List[str] = [str(i) for i in ids]
        if len(set(self.ids)) != len(self.ids):
            raise ValueError(f"duplicate GPU ids {self.ids}")
        self.num_gpus = len(self.ids)
        self._free = list(self.ids)

    # -- detection ----------------------------------------------------------

    @classmethod
    def detect(cls) -> Optional["GpuSet"]:
        """Detect local GPUs without importing torch or opening a CUDA
        context in the driver.

        Order: an explicit count (``RTPU_GPUS=<n>``, the counterpart of
        the reference's ``RTPU_TPU_TOPOLOGY``), the driver's own
        ``CUDA_VISIBLE_DEVICES`` (its ids are the ones handed out; an
        empty value means none), then the ``/dev/nvidia<N>`` device nodes
        this process may open (counted, as the reference counts
        ``/dev/accel*``: a container can hold nodes of cards its device
        cgroup denies, which CUDA does not enumerate either). No GPU ->
        None.
        """
        override = os.environ.get("RTPU_GPUS")
        if override:
            n = int(override)
            return cls(n) if n > 0 else None
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        if visible is not None:
            ids = [v.strip() for v in visible.split(",") if v.strip()]
            # CUDA stops enumerating at the first invalid entry ("-1")
            if "-1" in ids:
                ids = ids[:ids.index("-1")]
            return cls(ids) if ids else None
        import glob

        n = 0
        for path in glob.glob("/dev/nvidia*"):
            if not os.path.basename(path)[len("nvidia"):].isdigit():
                continue
            try:
                os.close(os.open(path, os.O_RDWR))
            except OSError:
                continue
            n += 1
        return cls(n) if n else None

    # -- allocation ---------------------------------------------------------

    def available(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> Optional[List[str]]:
        """Take ``n`` free ids (lowest first), or None if fewer are free."""
        if n > len(self._free):
            return None
        picked, self._free = self._free[:n], self._free[n:]
        return picked

    def release(self, ids: List[str]):
        for i in ids:
            if i in self.ids and i not in self._free:
                self._free.append(i)
        self._free.sort(key=self.ids.index)

    def __repr__(self):
        return f"GpuSet(free={self._free}, ids={self.ids})"


def node_resources(num_cpus: Optional[int] = None,
                   gpus: Optional[GpuSet] = None,
                   object_store_memory: int = 0) -> Dict[str, float]:
    """Total resource vector for a node: CPU, GPU (when the node has
    any) and object-store memory."""
    r: Dict[str, float] = {"CPU": float(num_cpus or os.cpu_count() or 1)}
    if object_store_memory:
        r["object_store_memory"] = float(object_store_memory)
    if gpus is not None and gpus.num_gpus:
        r["GPU"] = float(gpus.num_gpus)
    return r
