"""Multi-device meta-mode sweep: the batched (contig, bin) launch sharded
over a device mesh.

The launch tensors already have a flat work-item axis (BT); sharding that
axis over the mesh's contig axis makes the sweep data-parallel: geometries
and the bin tables are replicated (they are shared lookups), every device
scores + DPs its own slice of work items, and the per-item outputs come
back sharded.  No collectives are needed in the sweep itself — the winner
reduction spans launches on the host.  (The reference has no distributed
analog; its outermost parallelism is a thread pool over contigs,
cli.py:286-302.)
"""

import functools

import jax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from .mesh import CONTIG_AXIS
from ..ops import score_device as sd


def sharded_score_dp_launch(mesh, tables, geo, bin_idx, gidx, *, is_meta,
                            closed, S3, has_nonsd, relk, max_overlap,
                            lookback, interpret=False):
    """`score_device.score_dp_launch` with the work-item axis sharded over
    the mesh.  BT must be divisible by the mesh size."""
    repl = lambda tree: jax.tree.map(lambda _: P(), tree)   # noqa: E731

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(repl(tables), repl(geo), P(CONTIG_AXIS), P(CONTIG_AXIS)),
        out_specs=(P(CONTIG_AXIS, None), P(CONTIG_AXIS, None),
                   P(CONTIG_AXIS, None), P(CONTIG_AXIS)),
        check_vma=False,
    )
    def run(tables_, geo_, bin_idx_, gidx_):
        return sd.score_dp_launch(
            tables_, geo_, bin_idx_, gidx_, is_meta=is_meta, closed=closed,
            S3=S3, has_nonsd=has_nonsd, relk=relk, max_overlap=max_overlap,
            lookback=lookback, interpret=interpret)

    return run(tables, geo, bin_idx, gidx)


def sharded_score_dp_launch_packed(mesh, tables, geo, bin_idx, gidx, *,
                                   is_meta, closed, S3, has_nonsd, relk,
                                   max_overlap, lookback, interpret=False):
    """Sharded sweep + per-item best-score packing: the per-item sweep runs
    data-parallel over the mesh's contig axis and the packed (BT,) result
    comes back sharded the same way."""

    @jax.jit
    def run(tables_, geo_, bin_idx_, gidx_):
        *_, best = sharded_score_dp_launch(
            mesh, tables_, geo_, bin_idx_, gidx_, is_meta=is_meta,
            closed=closed, S3=S3, has_nonsd=has_nonsd, relk=relk,
            max_overlap=max_overlap, lookback=lookback, interpret=interpret)
        return sd.pack_winners(best)

    return run(tables, geo, bin_idx, gidx)


def sharded_score_dp_launch_mega(mesh, tables, geo, bin_idx, gidx, *,
                                 is_meta, closed, S3, has_nonsd, relk,
                                 max_overlap, lookback, fxs,
                                 interpret=False):
    """The mega sweep with the BIN-row axis sharded over the mesh: the
    geometry and bin tables are replicated, each device scores + DPs its
    slice of candidate-bin rows (the rows are fully independent models of
    the same contig pack), and the per-row best scores come back sharded
    — a row-parallel analog of the reference's sequential bin sweep
    (lib.pyx:5339-5374).  The row count must be divisible by the mesh
    size."""
    packed = "nbound" in geo
    out_spec = P(None, CONTIG_AXIS) if packed else P(CONTIG_AXIS)
    repl = lambda tree: jax.tree.map(lambda _: P(), tree)   # noqa: E731

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(repl(tables), repl(geo), P(CONTIG_AXIS), P(CONTIG_AXIS)),
        out_specs=out_spec,
        check_vma=False,
    )
    def run(tables_, geo_, bin_idx_, gidx_):
        return sd.score_dp_launch_mega(
            tables_, geo_, bin_idx_, gidx_, is_meta=is_meta,
            closed=closed, S3=S3, has_nonsd=has_nonsd, relk=relk,
            max_overlap=max_overlap, lookback=lookback, fxs=fxs,
            interpret=interpret)

    return run(tables, geo, bin_idx, gidx)
