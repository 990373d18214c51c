"""Multi-device scaling for pyrodigal_tpu.

The reference is a single-process shared-memory library (SURVEY.md §2.5);
its parallelism is SIMD + a thread pool over contigs.  The device
equivalents implemented here:

* contigs are data-parallel sharded over a `jax.sharding.Mesh` axis
  ("contigs"); each device runs the scoring + DP pipeline for its shard;
* training count tables (hexamer background/gene counts, start tallies)
  are pure sums -> merged with `psum` across the mesh;
* trained models / metagenomic bins are replicated.
"""

from .mesh import make_mesh, sharded_dp
from .meta_shard import (
    sharded_score_dp_launch_packed,
    sharded_score_dp_launch_mega,
)
from .train import train_distributed, sharded_background_counts

__all__ = [
    "make_mesh",
    "sharded_dp",
    "sharded_score_dp_launch_packed",
    "sharded_score_dp_launch_mega",
    "train_distributed",
    "sharded_background_counts",
]
