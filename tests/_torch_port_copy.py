"""Run a reference test module's programs on the port.

``port_copy("test_cluster.py")`` reads that file of the reference's
suite, rewrites every name of the ``ray_tpu`` package to
``ray_tpu_torch`` and executes the result as a fresh module, which is
never entered in ``sys.modules``: its remote functions and classes are
pickled by value, as a ``__main__`` script's are, so the port's workers
need not import it. ``export`` then binds the copy's tests (renamed
``test_port_*``) and fixtures into a port test file, where they hold the
port to the reference test's own assertions. The reference's file itself
stays as it is and keeps running against ``ray_tpu``.
"""

from __future__ import annotations

import re
import types
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

TESTS = Path(__file__).resolve().parent
_PKG = re.compile(r"\bray_tpu\b")


def port_copy(ref_file: str,
              rewrite: Sequence[Tuple[str, str]] = ()) -> types.ModuleType:
    """The reference test module ``ref_file`` on ``ray_tpu_torch``.
    ``rewrite`` lists further (old, new) source replacements, each of
    which must match."""
    path = TESTS / ref_file
    src = _PKG.sub("ray_tpu_torch", path.read_text())
    for old, new in rewrite:
        assert old in src, f"{ref_file}: {old!r} not found"
        src = src.replace(old, new)
    mod = types.ModuleType("_port_" + path.stem)
    mod.__file__ = str(path)
    exec(compile(src, f"{path} (on ray_tpu_torch)", "exec"), mod.__dict__)
    return mod


def export(mod: types.ModuleType, ns: Dict[str, object],
           tests: Iterable[str], fixtures: Iterable[str] = ()) -> None:
    """Bind ``tests`` of ``mod`` into namespace ``ns`` as
    ``test_port_<name>`` and its ``fixtures`` under their own names."""
    for name in tests:
        assert name.startswith("test_"), name
        ns["test_port_" + name[len("test_"):]] = getattr(mod, name)
    for name in fixtures:
        ns[name] = getattr(mod, name)


def ref_tests(mod: types.ModuleType) -> list:
    """Every test function of ``mod``, in definition order."""
    return [n for n, v in vars(mod).items()
            if n.startswith("test_") and callable(v)]
