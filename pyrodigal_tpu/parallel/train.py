"""Distributed training: every O(bp) statistics scan sharded over a mesh.

The reference trains on ONE joined sequence in a single process
(reference: lib.pyx:5471-5575; multi-sequence joining lib.pyx:5536-5543).
Both O(bp) pieces of that — the background hexamer scan and the
gene-hexamer scan over the training path's genes (`calc_dicodon_gene`,
lib.pyx:4284-4358) — are pure count tables, so they shard exactly:

* the training set's CONTIGS are assigned round-robin to the mesh
  devices (each contig slice carries a 5-base halo so every hexamer is
  read by exactly one owner), and
* the per-device 4096-bin tables are `psum`-merged across the devices, then
  finalized into `gene_dc` by the exact C log-ratio tail
  (`rc_dicodon_finalize`).

The merged counts are bit-identical to the host scans, so the final
`TrainingInfo` is bit-identical to `GeneFinder.train` on the joined
sequence.  The node-level passes (gc-bias recording, the training DP,
the SD/non-SD EM loops) stay on the exact C engine deliberately — they
are O(nodes)/O(genes), not O(bp), and the reference keeps them cheap on
one core.
"""

import ctypes
import functools

import numpy as np

from ..sequence import Sequence
from ..nodes import Nodes
from ..training import TrainingInfo
from .. import _native
from .mesh import CONTIG_AXIS

_LINKER = "TTAATTAATTAA"


def _path_gene_hexamer_masks(nodes, ipath, slen):
    """Per-position hexamer-start masks of the training path's genes,
    mirroring the walk of rc_calc_dicodon_gene_bg (reference:
    lib.pyx:4320-4338): forward genes mark [left, right-5) step 3 in
    forward coordinates, reverse genes the same in reverse-complement
    coordinates."""
    fwd = np.zeros(slen, bool)
    rev = np.zeros(slen, bool)
    strand = nodes.strand
    typ = nodes.type
    ndx = nodes.ndx
    tb = nodes.traceb
    path = ipath
    in_gene = 0
    left = right = -1
    while path != -1:
        if strand[path] == 1:
            if typ[path] == 3:
                in_gene = 1
                right = int(ndx[path]) + 2
            elif in_gene == 1:
                left = int(ndx[path])
                if right - 5 > left:
                    fwd[left:right - 5:3] = True
                in_gene = 0
        else:
            if typ[path] != 3:
                in_gene = -1
                left = slen - int(ndx[path]) - 1
            elif in_gene == -1:
                right = slen - int(ndx[path]) + 1
                if right - 5 > left:
                    rev[left:right - 5:3] = True
                in_gene = 0
        path = int(tb[path])
    return fwd, rev


def _pack_ranges(digits, bg_mask, gene_mask, ranges, D):
    """Round-robin the per-contig owned ranges over D devices; each range
    ships its digits with a 5-byte halo so its hexamers read locally.
    Returns (D, L) uint8 digits + (D, L) bool masks (False on halos and
    padding, so masked positions contribute nothing)."""
    per_dev = [[] for _ in range(D)]
    for k, (lo, hi) in enumerate(ranges):
        if hi > lo:
            per_dev[k % D].append((lo, hi))
    slen = len(digits)
    lens = [sum(min(hi + 5, slen) - lo for lo, hi in rs) for rs in per_dev]
    L = max(max(lens), 6) if lens else 6
    dig = np.zeros((D, L), np.uint8)
    bgm = np.zeros((D, L), bool)
    gnm = np.zeros((D, L), bool)
    for dev, rs in enumerate(per_dev):
        off = 0
        for lo, hi in rs:
            stop = min(hi + 5, slen)
            n = stop - lo
            dig[dev, off:off + n] = digits[lo:stop]
            bgm[dev, off:off + hi - lo] = bg_mask[lo:hi]
            gnm[dev, off:off + hi - lo] = gene_mask[lo:hi]
            off += n
    return dig, bgm, gnm


def _sharded_counts(mesh, dig, bgm, gnm):
    """Per-device hexamer tallies over the packed slices, psum-merged."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(CONTIG_AXIS, None),) * 3,
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step(x, bm, gm):
        L = x.shape[1]
        idx = jnp.zeros(L - 5, jnp.int32)
        for j in range(6):
            idx = idx | ((x[0, j:j + L - 5].astype(jnp.int32) & 3)
                         << (2 * j))
        # int32 on purpose: per-bin counts are bounded by 2*slen, far
        # below 2^31 for any real input (train_distributed asserts)
        bg = jnp.zeros(4096, jnp.int32).at[idx].add(
            bm[0, :L - 5].astype(jnp.int32))
        gn = jnp.zeros(4096, jnp.int32).at[idx].add(
            gm[0, :L - 5].astype(jnp.int32))
        return (jax.lax.psum(bg, CONTIG_AXIS),
                jax.lax.psum(gn, CONTIG_AXIS))

    import jax.numpy as jnp
    bg, gn = step(jnp.asarray(dig), jnp.asarray(bgm), jnp.asarray(gnm))
    return np.asarray(bg, np.int64), np.asarray(gn, np.int64)


def _balance(ranges, D, total):
    """Split ranges into position chunks of at most ~total/(2D) so the
    round-robin assignment stays balanced even for one huge contig (or a
    skewed contig-size distribution)."""
    step = max(1, -(-total // (2 * D)))
    out = []
    for lo, hi in ranges:
        p = lo
        while p < hi:
            out.append((p, min(p + step, hi)))
            p += step
    return out


def sharded_background_counts(mesh, digits):
    """Background hexamer counts of one (joined) digit sequence, position
    shards psum-merged over the mesh.  Bit-identical to the C scan in
    `rc_calc_dicodon_gene` (both strands; N folds to C, complement of N
    folds to C)."""
    d = np.asarray(digits, np.uint8)
    slen = len(d)
    assert slen < 2 ** 30, "int32 count tables assume slen < 2^30"
    npos = max(slen - 5, 0)
    comp = np.where(d < 4, 3 - d, d)[::-1].astype(np.uint8)
    D = mesh.devices.size
    # ONE launch: forward and reverse-complement coordinates live side by
    # side in a concatenated source, with the reverse ranges offset
    both = np.concatenate([d, comp])
    valid = np.zeros(2 * slen, bool)
    valid[:npos] = True
    valid[slen:slen + npos] = True
    ranges = _balance([(0, npos), (slen, slen + npos)], D, 2 * npos)
    none = np.zeros(2 * slen, bool)
    bg, _ = _sharded_counts(mesh, *_pack_ranges(both, valid, none,
                                                ranges, D))
    return bg


def train_distributed(mesh, sequence, *sequences, translation_table=11,
                      start_weight=4.35, force_nonsd=False, closed=False,
                      mask=False, min_mask=50, min_gene=90,
                      min_edge_gene=60, max_overlap=60):
    """`GeneFinder.train` with every O(bp) statistics scan contig-sharded
    over the mesh — bit-identical output.

    Accepts a metagenome-scale training set (any number of contigs); the
    contigs are joined with the reference's TTAATTAATTAA linker
    (lib.pyx:5536-5543) for the node-level passes, while the background
    AND gene hexamer tallies are computed per contig on the mesh devices
    and psum-merged, then finalized by the exact C log-ratio
    (`rc_dicodon_finalize`)."""
    contigs = [sequence, *sequences]
    if sequences:
        sequence = _LINKER.join([*contigs, ""])
    seq = Sequence(sequence, mask=mask, mask_size=min_mask)
    assert seq.slen < 2 ** 30, "int32 count tables assume slen < 2^30"
    tinf = TrainingInfo(seq.gc, start_weight=start_weight,
                        translation_table=translation_table)

    from .._constants import WINDOW

    nodes = Nodes()
    nodes.extract(seq, translation_table=translation_table, closed=closed,
                  min_gene=min_gene, min_edge_gene=min_edge_gene)
    nodes.sort()
    gc_plot = seq.max_gc_frame_plot(WINDOW)
    nodes.record_gc_bias(gc_plot, seq.slen, tinf)
    nodes.record_overlapping_starts(tinf, 0, max_overlap)
    ipath = nodes.dynamic_programming(tinf, final=False)

    # ---- contig-sharded O(bp) tallies ----------------------------------
    d = np.asarray(seq.digits, np.uint8)
    slen = seq.slen
    npos = max(slen - 5, 0)
    comp = np.where(d < 4, 3 - d, d)[::-1].astype(np.uint8)
    gene_f, gene_r = _path_gene_hexamer_masks(nodes, ipath, slen)
    bg_valid = np.zeros(slen, bool)
    bg_valid[:npos] = True

    # per-contig owned ranges of the joined sequence (each contig owns its
    # span plus the following linker); reverse-coordinate ranges mirror.
    # Forward and reverse coordinates live side by side in one
    # concatenated source so a single launch tallies both strands, and
    # large contigs are split into balanced position chunks.
    offs = [0]
    for c in contigs:
        offs.append(min(offs[-1] + len(c) + len(_LINKER), slen))
    offs[-1] = slen
    fwd_ranges = [(offs[k], min(offs[k + 1], npos))
                  for k in range(len(contigs))]
    rev_ranges = [(slen + max(slen - offs[k + 1], 0),
                   slen + min(slen - offs[k], npos))
                  for k in range(len(contigs))]

    D = mesh.devices.size
    both = np.concatenate([d, comp])
    bg_valid2 = np.concatenate([bg_valid, bg_valid])
    gene_both = np.concatenate([gene_f, gene_r])
    ranges = _balance(fwd_ranges + rev_ranges, D, 2 * npos)
    bg, gene = _sharded_counts(
        mesh, *_pack_ranges(both, bg_valid2, gene_both, ranges, D))

    s = nodes._struct()
    _native.lib.rc_dicodon_finalize(
        _native.u8(tinf.raw), _native.i64(bg), _native.i64(gene))
    _native.lib.rc_raw_coding_score(
        _native.u8(seq.digits), seq.slen, ctypes.byref(s),
        _native.u8(tinf.raw))
    _native.lib.rc_rbs_score(
        _native.u8(seq.digits), seq.slen, ctypes.byref(s),
        _native.u8(tinf.raw))
    _native.lib.rc_train_starts_sd(
        _native.u8(seq.digits), seq.slen, ctypes.byref(s),
        _native.u8(tinf.raw))
    if force_nonsd:
        tinf.uses_sd = False
    else:
        _native.lib.rc_determine_sd_usage(_native.u8(tinf.raw))
    if not tinf.uses_sd:
        _native.lib.rc_train_starts_nonsd(
            _native.u8(seq.digits), seq.slen, ctypes.byref(s),
            _native.u8(tinf.raw))
    return tinf
