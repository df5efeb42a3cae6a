"""Training-side pieces that need no runtime: sharded checkpoints on
``torch.distributed.checkpoint`` (``dist_checkpoint``) and the
predictor over an apply function and a params tree (``predictor``)."""
