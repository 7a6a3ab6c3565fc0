"""Multi-process execution on torch.distributed (port of nn_bvh_tpu/dist/):
the pixel-band sharded render, the collectives of the data-parallel
learner (sharding.py), and the torchrun-style launch and render-state
checkpoints (multihost.py)."""
