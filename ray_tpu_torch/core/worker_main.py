"""Entry-point shim: ``python -m ray_tpu_torch.core.worker_main [--zygote]``.

Kept separate from the implementation so that classes defined in the worker
module are never duplicated between ``__main__`` and the canonical module
path (which would break isinstance checks on unpickled objects).

``--zygote`` starts the pre-warmed fork template instead of a worker
(reference: prestarted workers, src/ray/raylet/worker_pool.h:344).
"""

import sys

from ray_tpu_torch.core.worker_proc import main, zygote_main

if __name__ == "__main__":
    if "--zygote" in sys.argv[1:]:
        zygote_main()
    else:
        main()
