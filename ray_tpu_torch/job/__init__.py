"""Job submission. The port holds only ``backoff.delay_for``, which the
GCS's orphaned-job scan computes its re-queue delays with; the client,
the agent and the job table's CLI come with the rest of the package
(ROADMAP.md section 1, item 6).
"""
