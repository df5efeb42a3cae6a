"""The runtime pieces the port's serving path reads: the two serving
flags of ``ray_tpu/core/config.py`` (``config``) and the
``prefill_handoff`` fault site of ``ray_tpu/core/fault_injection.py``."""
