"""Declarative Serve deploys from a config file.

The port's copy of ``ray_tpu/serve/config_deploy.py``.

Reference: python/ray/serve/schema.py:707 (ServeDeploySchema) + the
``serve deploy config.yaml`` CLI: the desired state of every application
lives in one document; applying it converges the cluster. Schema::

    applications:
      - name: my_app                 # optional; defaults to deployment name
        import_path: mypkg.mod:thing # callable/class, or a Deployment
        deployment_name: thing       # optional override
        init_args: []                # class deployments
        init_kwargs: {}
        num_replicas: 2
        max_batch_size: 0
        autoscaling_config: {min_replicas: 1, max_replicas: 4}
        engine: false

``apply`` deploys every listed application and DELETES deployments that
are no longer in the document (declarative convergence, like the
reference's declarative REST deploy).
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Union


def _load_target(import_path: str):
    mod_name, _, attr = import_path.partition(":")
    if not attr:
        mod_name, _, attr = import_path.rpartition(".")
    mod = importlib.import_module(mod_name)
    return getattr(mod, attr)


def apply(config: Union[str, Dict[str, Any]], prune: bool = True
          ) -> List[str]:
    """Deploy the applications in ``config`` (a dict, or a path to a
    YAML/JSON file); with ``prune``, delete deployments absent from it.
    Returns the deployed names."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.api import Deployment

    if isinstance(config, str):
        import json

        with open(config) as f:
            text = f.read()
        try:
            import yaml

            doc = yaml.safe_load(text)
        except ImportError:  # pragma: no cover — yaml ships in the image
            doc = json.loads(text)
    else:
        doc = dict(config)

    apps = doc.get("applications") or []
    deployed: List[str] = []
    for app in apps:
        target = _load_target(app["import_path"])
        cfg = {k: v for k, v in app.items()
               if k in ("num_replicas", "max_batch_size",
                        "batch_wait_timeout_s", "autoscaling_config",
                        "engine")}
        if isinstance(target, Deployment):
            # the document overrides the decorator's own config
            dep = target.options(**cfg) if cfg else target
        else:
            dep = serve.deployment(target, **cfg)
        if app.get("init_args") or app.get("init_kwargs"):
            dep = dep.bind(*(app.get("init_args") or ()),
                           **(app.get("init_kwargs") or {}))
        name = (app.get("deployment_name") or app.get("name")
                or dep.name)
        serve.run(dep, name=name)
        deployed.append(name)

    if prune:
        try:
            existing = list(serve.status())
        except Exception:  # noqa: BLE001 — no controller: converged
            existing = []
        for name in existing:
            if name not in deployed:
                serve.delete(name)
    return deployed
