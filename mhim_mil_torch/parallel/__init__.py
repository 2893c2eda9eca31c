"""Multi-process data and sequence parallelism of the port (counterpart of mhim_mil_tpu/parallel)."""

from .mesh import batch_pspecs, make_mesh, replicate_tree, shard_batch

__all__ = ["make_mesh", "batch_pspecs", "shard_batch", "replicate_tree"]
