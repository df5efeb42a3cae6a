"""Runtime environments: ship code to workers (working_dir / py_modules).

Reference: python/ray/_private/runtime_env/ — there, working_dir and
py_modules are zipped, uploaded to the GCS package store, downloaded and
extracted by each node's runtime-env agent, then applied per worker
(chdir + sys.path). Here the same shape without a separate agent:

- driver: `prepare(core, runtime_env)` zips each local path into a
  content-addressed package and registers the bytes with the core
  (local runtime: in-process table; cluster: GCS KV `pkg:<hash>`),
  rewriting the env to hash references — the env dict that travels with
  the task/actor is small and serializable.
- worker: `apply(runtime_env, core)` fetches packages it doesn't have
  (REQ_PKG to its core, answered from the table / GCS KV), extracts them
  once into the session package cache, then chdirs into the working_dir
  and prepends py_modules to sys.path. Per-task application is restored
  after the task; actor-scoped application persists for the actor's
  lifetime (the worker is dedicated to it).

pip environments (reference: _private/runtime_env/pip.py) install into
a per-requirements-hash virtualenv (--system-site-packages) created
lazily node-side by the first worker that needs it. Tasks/actors pinned
to a pip env run on PER-ENV WORKER PROCESSES launched with the venv's
OWN interpreter (core/runtime.py env-keyed pools — the reference's
worker_pool.h:153 design): module versions are truly isolated, because
an env worker never imports outside its venv's resolution order and a
pooled worker never imports from a venv. The sys.path-activation path
below remains only for foreign-env application (a worker of env A told
to run env B — possible through nested submissions), where the
documented already-imported-module caveat still applies.
conda/image_uri isolation has a pluggable design: an ``EnvProvider``
maps a runtime_env kind to the interpreter its dedicated workers exec
(register_env_provider); pip ships built-in, conda/container providers
plug in where the host supplies the environment runtime (nothing
installable in this image — using those kinds without a provider is a
loud gated error, tested with a stub provider).
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import tempfile
import zipfile
from typing import Callable, Dict, Optional, Tuple

_EXCLUDE_DIRS = {".git", "__pycache__", ".venv", "node_modules", ".eggs"}
_EXCLUDE_SUFFIXES = (".pyc", ".pyo")
_MAX_PACKAGE_BYTES = 512 << 20


def _iter_files(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in _EXCLUDE_DIRS)
        for f in sorted(filenames):
            if f.endswith(_EXCLUDE_SUFFIXES):
                continue
            full = os.path.join(dirpath, f)
            yield os.path.relpath(full, root), full


def package_path(path: str, *, prefix: str = "") -> Tuple[str, bytes]:
    """Zip a directory (or single .py file) deterministically.

    Returns (content_hash, zip_bytes). The hash covers names + contents
    (not zip metadata), so identical trees share a package.
    """
    path = os.path.abspath(path)
    h = hashlib.sha256()
    entries = []
    if os.path.isfile(path):
        entries = [(os.path.basename(path), path)]
    elif os.path.isdir(path):
        entries = [(os.path.join(prefix, rel) if prefix else rel, full)
                   for rel, full in _iter_files(path)]
    else:
        raise FileNotFoundError(f"runtime_env path {path!r} does not exist")
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for arcname, full in entries:
            with open(full, "rb") as f:
                data = f.read()
            total += len(data)
            if total > _MAX_PACKAGE_BYTES:
                raise ValueError(
                    f"runtime_env package {path!r} exceeds "
                    f"{_MAX_PACKAGE_BYTES >> 20} MiB")
            h.update(arcname.encode())
            h.update(b"\0")
            h.update(data)
            info = zipfile.ZipInfo(arcname, date_time=(1980, 1, 1, 0, 0, 0))
            zf.writestr(info, data)
    return h.hexdigest()[:32], buf.getvalue()


def _tree_signature(path: str):
    """Cheap change detector: (file count, max mtime_ns, total bytes).
    Walking stats is ~100x cheaper than re-reading + zipping the tree on
    every .remote() call."""
    if os.path.isfile(path):
        st = os.stat(path)
        return (1, st.st_mtime_ns, st.st_size)
    n = mt = size = 0
    for _, full in _iter_files(path):
        st = os.stat(full)
        n += 1
        mt = max(mt, st.st_mtime_ns)
        size += st.st_size
    return (n, mt, size)


def _package_cached(core, path: str, *, prefix: str = "") -> str:
    """Package + register once per unchanged tree; returns the hash."""
    cache = getattr(core, "_renv_cache", None)
    if cache is None:
        cache = core._renv_cache = {}
    key = (os.path.abspath(path), prefix)
    sig = _tree_signature(os.path.abspath(path))
    hit = cache.get(key)
    if hit and hit[0] == sig:
        return hit[1]
    h, data = package_path(path, prefix=prefix)
    core.register_package(h, data)
    cache[key] = (sig, h)
    return h


def prepare(core, runtime_env: Optional[dict]) -> Optional[dict]:
    """Driver-side: package local paths, register bytes with the core,
    rewrite the env to content-hash references."""
    if not runtime_env:
        return runtime_env
    if "working_dir_pkg" in runtime_env or "py_modules_pkgs" in runtime_env:
        return runtime_env  # already prepared (e.g. re-submission)
    out = dict(runtime_env)
    wd = out.pop("working_dir", None)
    if wd is not None:
        out["working_dir_pkg"] = _package_cached(core, wd)
    mods = out.pop("py_modules", None)
    if mods:
        hashes = []
        for m in mods:
            m = os.path.abspath(m)
            # a module DIRECTORY must stay importable after extraction:
            # nest it under its own name so sys.path points at the parent
            prefix = os.path.basename(m.rstrip(os.sep)) \
                if os.path.isdir(m) else ""
            hashes.append(_package_cached(core, m, prefix=prefix))
        out["py_modules_pkgs"] = hashes
    return out


def ensure_extracted(cache_root: str, pkg_hash: str,
                     fetch: Callable[[str], bytes]) -> str:
    """Extract package ``pkg_hash`` under the cache once; returns its dir.
    Atomic against concurrent workers (extract to temp + rename)."""
    dest = os.path.join(cache_root, pkg_hash)
    if os.path.isdir(dest):
        return dest
    data = fetch(pkg_hash)
    if data is None:
        raise FileNotFoundError(
            f"runtime_env package {pkg_hash} not found in the package "
            "store (was it registered by the submitting driver?)")
    tmp = f"{dest}.tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        zf.extractall(tmp)
    try:
        os.rename(tmp, dest)
    except OSError:
        # another worker won the race; ours is redundant
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return dest


def _pip_env_key(packages, options) -> str:
    blob = "\n".join(sorted(packages)) + "\0" + " ".join(options)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def normalize_pip(spec) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """runtime_env["pip"] forms: a list of requirement strings, or a
    dict {"packages": [...], "pip_install_options": [...]}."""
    if isinstance(spec, (list, tuple)):
        return tuple(str(p) for p in spec), ()
    if isinstance(spec, dict):
        return (tuple(str(p) for p in spec.get("packages") or ()),
                tuple(str(o) for o in
                      spec.get("pip_install_options") or ()))
    raise ValueError(
        f"runtime_env['pip'] must be a list of requirements or a dict "
        f"with 'packages'; got {type(spec).__name__}")


def ensure_pip_env(cache_root: str, packages, options) -> str:
    """Create (once per node+requirements hash) a virtualenv with the
    requested packages; returns its site-packages dir.

    Concurrency: installers compete for an O_EXCL lock file carrying the
    holder's pid; the .done marker caches success. A SIGKILLed holder's
    lock is broken by renaming it aside (atomic election) — the breaker
    then LOOPS BACK to compete for a fresh lock like everyone else, so
    dest is only ever rebuilt by a process that holds the lock (no
    window where a breaker can rmtree a new installer's in-progress
    venv)."""
    import glob
    import shutil
    import subprocess
    import time

    key = _pip_env_key(packages, options)
    pip_root = os.path.join(cache_root, "pip")
    dest = os.path.join(pip_root, key)
    done = os.path.join(dest, ".done")
    lock = os.path.join(pip_root, f"{key}.lock")
    os.makedirs(pip_root, exist_ok=True)

    def site_packages() -> str:
        hits = glob.glob(os.path.join(dest, "lib", "python*",
                                      "site-packages"))
        if not hits:
            raise FileNotFoundError(f"pip env {key} has no site-packages")
        return hits[0]

    def lock_holder_dead(path) -> bool:
        """True when the pid written into the lock file no longer runs —
        a SIGKILLed installer must not brick this env forever."""
        try:
            pid = int(open(path).read().strip() or 0)
        except OSError:
            return False  # already reclaimed by a competing breaker
        except ValueError:
            pid = 0
        if pid <= 0:
            # empty/garbled lock: the installer died between O_EXCL
            # create and writing its pid. Mid-write is indistinguishable,
            # so require the file to be old enough that any live writer
            # would long since have finished its two-line write.
            try:
                return time.time() - os.path.getmtime(path) > 30.0
            except OSError:
                return False
        try:
            os.kill(pid, 0)
            return False
        except ProcessLookupError:
            return True
        except PermissionError:
            return False

    deadline = time.monotonic() + 600
    while True:
        if os.path.exists(done):
            return site_packages()
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            if lock_holder_dead(lock):
                # atomic rename elects ONE breaker; it merely clears the
                # dead lock and loops back to compete — dest is touched
                # only under a held lock
                stale = f"{lock}.stale.{os.getpid()}"
                try:
                    os.rename(lock, stale)
                    os.remove(stale)
                except OSError:
                    pass
                continue
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"pip env {key} install did not finish within 600s "
                    f"(holder of {lock} may be stuck)")
            time.sleep(0.2)
            continue
        try:
            os.write(fd, str(os.getpid()).encode())
            if os.path.exists(done):
                return site_packages()
            # a previous holder may have died mid-install: rebuild from
            # scratch (we hold the lock, nobody else is writing here)
            shutil.rmtree(dest, ignore_errors=True)
            subprocess.run(
                [sys.executable, "-m", "venv", "--system-site-packages",
                 dest], check=True, capture_output=True)
            py = os.path.join(dest, "bin", "python")
            # --system-site-packages resolves to the BASE prefix; when
            # THIS interpreter is itself a venv (common in container
            # images), its own site-packages — the framework's deps —
            # would be invisible to env workers running <venv>/bin/python.
            # Link every parent site dir via a .pth: processed after the
            # env's own site-packages dir, so env-pinned versions still
            # win.
            parents = [p for p in sys.path
                       if p.endswith(("site-packages", "dist-packages"))
                       and os.path.isdir(p)]
            if parents:
                for sp_dir in glob.glob(os.path.join(
                        dest, "lib", "python*", "site-packages")):
                    with open(os.path.join(
                            sp_dir, "_rtpu_parent_paths.pth"), "w") as f:
                        f.write("\n".join(parents) + "\n")
            proc = subprocess.run(
                [py, "-m", "pip", "install", "--disable-pip-version-check",
                 *options, *packages],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"pip install failed for runtime_env packages "
                    f"{list(packages)}:\n{proc.stderr[-2000:]}")
            with open(done, "w") as f:
                f.write("\n".join(packages))
            return site_packages()
        finally:
            os.close(fd)
            try:
                os.remove(lock)
            except OSError:
                pass


def apply(runtime_env: Optional[dict], fetch: Callable[[str], bytes],
          cache_root: Optional[str] = None,
          own_pip_key: Optional[str] = None):
    """Worker-side: apply env_vars, working_dir, py_modules.

    ``own_pip_key``: the pip-env key this worker's interpreter IS (env
    workers run their venv's python). A task pinned to the same env
    needs no sys.path surgery or post-task module purge — that is the
    point of per-env worker processes.

    Returns opaque state for ``restore`` (None when nothing applied).
    """
    if not runtime_env:
        return None
    if "working_dir" in runtime_env or "py_modules" in runtime_env:
        # raw paths mean prepare() never ran (e.g. a core without
        # prepare_runtime_env support): fail loudly, not silently
        raise ValueError(
            "runtime_env working_dir/py_modules were not prepared by the "
            "submitting process — submit from a driver or a worker core "
            "with prepare_runtime_env support")
    cache_root = cache_root or os.environ.get(
        "RTPU_PKG_DIR", os.path.join(tempfile.gettempdir(), "rtpt_pkgs"))
    os.makedirs(cache_root, exist_ok=True)
    saved_env = None
    saved_cwd = None
    saved_path: Optional[list] = None
    pip_sp: Optional[str] = None
    try:
        env_vars = runtime_env.get("env_vars")
        if env_vars:
            saved_env = {k: os.environ.get(k) for k in env_vars}
            os.environ.update({k: str(v) for k, v in env_vars.items()})
        wd_hash = runtime_env.get("working_dir_pkg")
        mod_hashes = runtime_env.get("py_modules_pkgs") or []
        pip_spec = runtime_env.get("pip")
        if wd_hash or mod_hashes or pip_spec:
            saved_path = list(sys.path)
        if pip_spec:
            packages, options = normalize_pip(pip_spec)
            key = f"pip:{_pip_env_key(packages, options)}"
            if packages and key != own_pip_key:
                pip_sp = ensure_pip_env(cache_root, packages, options)
                sys.path.insert(0, pip_sp)
        if wd_hash:
            wd = ensure_extracted(cache_root, wd_hash, fetch)
            saved_cwd = os.getcwd()
            os.chdir(wd)
            sys.path.insert(0, wd)
        for h in mod_hashes:
            sys.path.insert(0, ensure_extracted(cache_root, h, fetch))
    except BaseException:
        # half-applied env must not leak into the pooled worker (e.g.
        # env_vars applied, then the pip install fails)
        restore((saved_env, saved_cwd, saved_path, pip_sp))
        raise
    if (saved_env is None and saved_cwd is None and saved_path is None
            and pip_sp is None):
        return None
    return (saved_env, saved_cwd, saved_path, pip_sp)


def restore(state) -> None:
    if state is None:
        return
    saved_env, saved_cwd, saved_path, pip_sp = state
    if pip_sp:
        # sys.path restore alone is not isolation: modules already
        # imported from the env's site-packages live on in sys.modules
        # and would satisfy env-less imports on this pooled worker
        prefix = pip_sp + os.sep
        for name, mod in list(sys.modules.items()):
            f = getattr(mod, "__file__", None)
            if f and f.startswith(prefix):
                del sys.modules[name]
                continue
            paths = getattr(mod, "__path__", None)
            if paths is not None:
                try:
                    if any(str(p).startswith(prefix) for p in paths):
                        del sys.modules[name]
                except TypeError:
                    pass
    if saved_env:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if saved_cwd is not None:
        try:
            os.chdir(saved_cwd)
        except OSError:
            pass
    if saved_path is not None:
        sys.path[:] = saved_path


# ---- env providers: pluggable interpreter-level isolation ------------------

class EnvProvider:
    """Provision an isolated interpreter for a runtime_env kind
    (reference roles: _private/runtime_env/{pip,conda,image_uri}.py —
    each plugin materializes an environment and the worker launches
    inside it). ``prepare`` may block (builds cache-once); it returns
    how to launch a worker for the env. Register concrete providers
    with ``register_env_provider``; tasks/actors whose runtime_env
    carries the kind then run on dedicated workers launched through it
    (core/runtime.py env-keyed pools)."""

    kind: str = ""

    def env_key(self, spec) -> str:
        """Stable content key: equal specs share a worker pool."""
        raise NotImplementedError

    def prepare(self, spec) -> "PreparedEnv":
        """Materialize the env (idempotent; may block on first build)."""
        raise NotImplementedError


class PreparedEnv:
    """How to launch a worker inside an env: the interpreter to exec and
    extra process environment."""

    def __init__(self, python_exe: str,
                 env_vars: Optional[Dict[str, str]] = None):
        self.python_exe = python_exe
        self.env_vars = dict(env_vars or {})


class PipEnvProvider(EnvProvider):
    """The built-in provider: per-requirements-hash virtualenvs."""

    kind = "pip"

    def __init__(self, cache_root: Optional[str] = None):
        self._cache_root = cache_root

    def _root(self) -> str:
        return self._cache_root or os.environ.get(
            "RTPU_PKG_DIR", os.path.join(tempfile.gettempdir(), "rtpt_pkgs"))

    def env_key(self, spec) -> str:
        packages, options = normalize_pip(spec)
        return _pip_env_key(packages, options)

    def prepare(self, spec) -> PreparedEnv:
        packages, options = normalize_pip(spec)
        site = ensure_pip_env(self._root(), packages, options)
        venv_root = os.path.dirname(os.path.dirname(os.path.dirname(site)))
        return PreparedEnv(os.path.join(venv_root, "bin", "python"))


_ENV_PROVIDERS: Dict[str, EnvProvider] = {"pip": PipEnvProvider()}

# runtime_env kinds that NEED a provider; absent one, using them is a
# loud gated error, not a silent no-op (conda/image_uri have nothing
# installable in this image — the interface is how a deployment with a
# conda binary or a container runtime plugs in)
_PROVIDER_KINDS = ("pip", "conda", "image_uri")


def register_env_provider(provider: EnvProvider) -> None:
    """Install (or replace) the provider for ``provider.kind``."""
    if not provider.kind:
        raise ValueError("provider.kind must be a non-empty string")
    _ENV_PROVIDERS[provider.kind] = provider


def resolve_env_provider(runtime_env: Optional[dict]):
    """(kind, provider, spec) for the isolation-bearing part of a
    runtime_env, or None. Raises for a kind with no provider."""
    if not runtime_env:
        return None
    present = [k for k in _PROVIDER_KINDS if runtime_env.get(k)]
    if not present:
        return None
    if len(present) > 1:
        raise ValueError(
            f"runtime_env carries multiple isolation kinds {present}; "
            "pick one of pip/conda/image_uri")
    kind = present[0]
    provider = _ENV_PROVIDERS.get(kind)
    if provider is None:
        raise ValueError(
            f"runtime_env[{kind!r}] requires a registered EnvProvider "
            "(ray_tpu_torch.core.runtime_env.register_env_provider); none is "
            "installed — conda/container isolation needs the host to "
            "supply the environment runtime")
    return kind, provider, runtime_env[kind]
