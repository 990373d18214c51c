"""On-device per-bin node scoring for meta mode.

The reference scores every candidate metagenomic model over the same node
geometry (reference: lib.pyx:5317-5396 — the bin sweep re-runs
`Nodes._score` + `_record_overlapping_starts` + the DP per bin).  Here the
whole per-bin pipeline runs on the accelerator:

* the 50 models' tables (gene_dc, rbs_wt, ups_comp, mot_wt, type_wt, ...)
  are uploaded ONCE and stay device-resident;
* per contig, only the *digit sequence* and the core node fields cross the
  link (~100 KB per contig): every candidate tensor — 6-mer codes, SD
  candidate masks (via (15, 4096) lookup tables of the scanners' candidate
  sets), upstream mers, motif candidate indices, star-candidate windows —
  is derived ON DEVICE from the digits + node positions
  (reference: lib.pyx:2119-2239, 791-979, 1556-1650, 2279-2329);
* scoring for a whole batch of (contig, bin) work items becomes gathers,
  segmented scans and elementwise selects over (BT, n) tensors, fused by
  XLA into the same dispatch as the Pallas DP kernel (dp_pallas).

Numerics are float32 (the exact float64 C engine re-scores the winning bin
on the host for output fidelity); the differential tests bound the drift.
"""

import ctypes
import functools

import numpy as np
import jax
import jax.numpy as jnp

from .._constants import STOP
from .. import _native
from . import dp_jax, dp_pallas

EDGE_BONUS = 0.74
EDGE_UPS = -1.0
META_PEN = 7.5

F32 = jnp.float32


# --------------------------------------------------------------------------
# device-resident per-bin tables
# --------------------------------------------------------------------------

def _sd_luts():
    """The SD scanners' candidate-set masks, tabulated over (distance,
    6-mer) — see rc_sd_cand_luts (reference: lib.pyx:791-979)."""
    ex = np.zeros((15, 4096), np.int32)
    mm = np.zeros((15, 4096), np.int32)
    _native.lib.rc_sd_cand_luts(_native.i32(ex), _native.i32(mm))
    return ex.reshape(-1), mm.reshape(-1)


class BinTables:
    """Stacked per-bin training tables, uploaded once."""

    def __init__(self, metagenomic_bins):
        tis = [b.training_info for b in metagenomic_bins]
        nb = len(tis)
        gene_dc = np.zeros((nb, 4096), np.float32)
        rbs_wt = np.zeros((nb, 28), np.float32)
        ups_comp = np.zeros((nb, 128), np.float32)
        type_wt = np.zeros((nb, 3), np.float32)
        mot_wt = np.zeros((nb, 65536), np.float32)
        st_wt = np.zeros(nb, np.float32)
        no_mot = np.zeros(nb, np.float32)
        uses_sd = np.zeros(nb, np.int32)
        log_no_stop = np.zeros(nb, np.float32)
        lfac_min = np.zeros(nb, np.float32)
        lfac_max = np.zeros(nb, np.float32)
        for k, ti in enumerate(tis):
            gene_dc[k] = ti.coding_statistics
            rbs_wt[k] = ti.rbs_weights_array
            ups_comp[k] = np.asarray(ti.upstream_compositions,
                                     np.float64).reshape(-1)
            type_wt[k] = ti.type_weights
            mot_wt[k] = np.asarray(ti.motif_weights, np.float64).reshape(-1)
            st_wt[k] = ti.start_weight
            no_mot[k] = ti.missing_motif_weight
            uses_sd[k] = int(ti.uses_sd)
            gc = float(ti.gc)
            # (reference: lib.pyx:2131-2147)
            if ti.translation_table != 11:
                ns = ((1 - gc) ** 2 * gc) / 8.0 + ((1 - gc) ** 3) / 8.0
            else:
                ns = ((1 - gc) ** 2 * gc) / 4.0 + ((1 - gc) ** 3) / 8.0
            ns = 1.0 - ns
            log_no_stop[k] = np.log(ns)
            lfac_max[k] = np.log((1 - ns ** 1000.0) / ns ** 1000.0)
            lfac_min[k] = np.log((1 - ns ** 80.0) / ns ** 80.0)
        self.nb = nb
        self.gene_dc = jnp.asarray(gene_dc)
        self.rbs_wt = jnp.asarray(rbs_wt)
        self.ups_comp = jnp.asarray(ups_comp)
        self.type_wt = jnp.asarray(type_wt)
        self.mot_wt = jnp.asarray(mot_wt)
        self.st_wt = jnp.asarray(st_wt)
        self.no_mot = jnp.asarray(no_mot)
        self.uses_sd = jnp.asarray(uses_sd)
        self.log_no_stop = jnp.asarray(log_no_stop)
        self.lfac_min = jnp.asarray(lfac_min)
        self.lfac_max = jnp.asarray(lfac_max)
        self.any_nonsd = bool((uses_sd == 0).any())
        self.uses_sd_np = uses_sd.copy()
        sd_ex, sd_mm = _sd_luts()
        self.sd_ex = jnp.asarray(sd_ex)
        self.sd_mm = jnp.asarray(sd_mm)
        # per-bin SD winner tables: wi[bin, p, code] = the index the SD
        # scanner at window position p returns for 6-mer `code` under this
        # bin's weights (per-position lex argmax by (weight, index); the
        # cross-position reduction downstream is a plain index max).
        # Rows are pre-flipped to window-position order (row p = distance
        # 20-p), and the exact / 1-mismatch winner pair is PACKED into one
        # f32 cell (ex * 32 + mm, both < 28 so the pack is integer-exact)
        # so one table lookup per window position serves both scanners.
        wi = np.zeros((2, nb, 15, 4096), np.float32)
        for which, masks in enumerate((sd_ex, sd_mm)):
            mm2 = masks.reshape(15, 4096)[::-1]          # row p = 14-p
            for k in range(nb):
                wt = rbs_wt[k]                           # float32
                best = np.zeros(mm2.shape, np.int32)
                bw = np.full(mm2.shape, wt[0], np.float32)
                for v in range(1, 28):
                    bit = (mm2 >> v) & 1
                    upd = (bit != 0) & ((wt[v] > bw)
                                        | ((wt[v] == bw) & (v > best)))
                    bw = np.where(upd, wt[v], bw)
                    best = np.where(upd, v, best)
                wi[which, k] = best
        self.sd_wi = jnp.asarray(wi[0] * 32.0 + wi[1])   # (nb, 15, 4096)

    def as_tuple(self):
        return (self.gene_dc, self.rbs_wt, self.ups_comp, self.type_wt,
                self.mot_wt, self.st_wt, self.no_mot, self.uses_sd,
                self.log_no_stop, self.lfac_min, self.lfac_max,
                self.sd_ex, self.sd_mm, self.sd_wi)


# --------------------------------------------------------------------------
# host-side geometry precompute (bin-independent, once per contig x table)
# --------------------------------------------------------------------------


def prepare_geometry(seq, nodes, tt, closed, max_overlap, relk):
    """Bin-independent host tensors for one (contig, translation table).

    Slim by design: only the digit sequence and the core node fields cross
    the host→device link; everything else (6-mer codes, SD masks, upstream
    mers, motif/star candidates) is derived on device.  `star_overflow` is
    set when some stop's star-candidate scan spans more than `relk` node
    indices (caller falls back to the host path; reference scan bounds:
    lib.pyx:2279-2329)."""
    nn = nodes.length
    slen = seq.slen
    s = nodes._struct()
    lib = _native.lib

    stop_real = np.zeros(nn, np.uint8)
    lib.rc_stop_real(_native.u8(seq.digits), slen, ctypes.byref(s), tt,
                     _native.u8(stop_real))
    euf = np.zeros(nn, np.uint8)
    lib.rc_edge_ups_flags(ctypes.byref(s), slen, int(closed),
                          _native.u8(euf))

    ndx = nodes.ndx[:nn]
    typ = nodes.type[:nn]
    strand = nodes.strand[:nn]
    edge = nodes.edge[:nn]

    win_lo = dp_jax.window_starts(
        ndx.astype(np.int64), nodes.stop_val[:nn].astype(np.int64),
        typ, strand).astype(np.int32)

    # star-candidate scan span (node indices), for the fixed device window
    idx = np.arange(nn)
    span = 0
    fstop = (typ == STOP) & (strand == 1) & (edge == 0)
    rstop = (typ == STOP) & (strand == -1) & (edge == 0)
    if fstop.any():
        jmin = np.searchsorted(ndx, ndx[fstop] - max_overlap, side="left")
        span = max(span, int((idx[fstop] + 3 - jmin).max()) + 1)
    if rstop.any():
        jmax = np.searchsorted(ndx, ndx[rstop] + max_overlap,
                               side="right") - 1
        span = max(span, int((jmax - idx[rstop] + 3).max()) + 1)

    return {
        "nn": nn, "slen": slen, "tt": tt,
        "ndx": ndx.astype(np.int32),
        "stop_val": nodes.stop_val[:nn].astype(np.int32),
        "win_lo": win_lo,
        "typ": typ.astype(np.int8),
        "strand": strand.astype(np.int8),
        "edge": edge.astype(np.int8),
        "stop_real": stop_real.astype(np.int8),
        "euf": euf.astype(np.int8),
        "digits": seq.digits,
        "star_overflow": span > relk,
    }


GEO_I32 = ("ndx", "stop_val", "win_lo")
GEO_I8 = ("typ", "strand", "edge", "stop_real", "euf", "valid")


def compress_geo(packed):
    """Pack the upload-heavy geometry rows for the host→device link
    (whether this pays on the card's host link is ROADMAP D2): digit
    sequences go 2 bases/byte (values 0-4 fit a nibble) and the six
    per-node int8 flag rows fold into one byte/node.  The jitted entry
    points transparently unpack (see `_unpack_geo`); numpy-side only."""
    out = {k: v for k, v in packed.items()
           if k not in ("digits", "n8", "cdigits")}
    for src, dst in (("digits", "dig4"), ("cdigits", "cdig4")):
        if src in packed:
            d = packed[src]
            if d.ndim == 1:
                d = d[None]
            if d.shape[1] % 2:
                d = np.pad(d, ((0, 0), (0, 1)))
            out[dst] = (d[:, 0::2] | (d[:, 1::2] << 4)).astype(np.uint8)
    n8 = packed["n8"].astype(np.uint8)
    typ, strand, edge, stop_real, euf, valid = n8
    out["n8p"] = ((typ & 3) | ((strand == 1).astype(np.uint8) << 2)
                  | ((edge & 1) << 3) | ((stop_real & 1) << 4)
                  | ((euf & 1) << 5) | ((valid & 1) << 6))
    return out


def _unpack_geo(geo):
    """Inverse of `compress_geo`, traced on device (the unpacking ops are
    a handful of shifts XLA fuses into the scoring pipeline).  Plain
    (uncompressed) geometry dicts pass through untouched."""
    if "n8p" not in geo:
        return geo
    g = dict(geo)
    for src, dst in (("dig4", "digits"), ("cdig4", "cdigits")):
        if src in g:
            d4 = g.pop(src)
            G2, S2 = d4.shape
            g[dst] = jnp.stack([d4 & 15, d4 >> 4],
                               axis=-1).reshape(G2, 2 * S2)
    p = g.pop("n8p").astype(jnp.int32)
    typ = p & 3
    strand = jnp.where((p >> 2) & 1 == 1, 1, -1)
    g["n8"] = jnp.stack([
        typ, strand, (p >> 3) & 1, (p >> 4) & 1, (p >> 5) & 1,
        (p >> 6) & 1]).astype(jnp.int8)
    return g


def pack_geometries(geoms, G, n, S):
    """Stack geometry dicts into fixed-shape arrays for one launch."""
    out = {
        "n32": np.zeros((len(GEO_I32), G, n), np.int32),
        "n8": np.zeros((len(GEO_I8), G, n), np.int8),
        "digits": np.zeros((G, S), np.uint8),
        "slen": np.zeros(G, np.int32),
    }
    out["n8"][1] = 1          # strand pad
    for gi, gd in enumerate(geoms):
        nn = gd["nn"]
        for fi, f in enumerate(GEO_I32):
            out["n32"][fi, gi, :nn] = gd[f]
        out["n32"][2, gi, nn:] = np.arange(nn, n)        # win_lo pad
        for fi, f in enumerate(GEO_I8[:-1]):
            out["n8"][fi, gi, :nn] = gd[f]
        out["n8"][5, gi, :nn] = 1                        # valid
        out["digits"][gi, :gd["slen"]] = gd["digits"]
        out["slen"][gi] = gd["slen"]
    return out


def pack_geometries_multi(geoms, NT, SB, CP, tile):
    """Lay several contig geometries end-to-end into ONE mega-kernel
    geometry (G = 1): node ranges are padded to `tile` multiples (so
    kernel tiles and the node-tile window gathers never straddle two
    contigs) and sequence ranges to 384-byte regions with a >= 384-zero
    gap (so no scoring window, star candidate, or intergenic test can
    reach across — max_overlap and every window span are < 384 bp).

    Positions/ndx/stop_val are globalized by each contig's sequence
    offset, win_lo by its node offset; interior node pads carry kind-4
    sentinels with MONOTONIC duplicate ndx (keeps the kind-2 overlap
    searchsorted exact).  Extra rows vs `pack_geometries`: "loc"/"lslen"
    (per-node local coordinate + contig length, for the slen-dependent
    scoring rules), "blo"/"bhi" (contig sequence bounds, for the m6r
    in-contig mask) and "nbound" (CP+1 node-range offsets, for the
    per-contig terminal reduction)."""
    C2 = len(geoms)
    assert C2 <= CP
    out = {
        "n32": np.zeros((len(GEO_I32), 1, NT), np.int32),
        "n8": np.zeros((len(GEO_I8), 1, NT), np.int8),
        "digits": np.zeros((1, SB), np.uint8),
        "slen": np.zeros(1, np.int32),
        "loc": np.zeros((1, NT), np.int32),
        "lslen": np.zeros((1, NT), np.int32),
        "blo": np.zeros(CP, np.int32),
        "bhi": np.zeros(CP, np.int32),
        "nbound": np.zeros(CP + 1, np.int32),
    }
    out["n8"][1] = 1          # strand pad
    nb = sb = 0
    last_ndx = 0
    for k, gd in enumerate(geoms):
        nn = gd["nn"]
        sl = slice(nb, nb + nn)
        out["n32"][0, 0, sl] = gd["ndx"] + sb
        out["n32"][1, 0, sl] = gd["stop_val"] + sb
        out["n32"][2, 0, sl] = gd["win_lo"] + nb
        for fi, f in enumerate(GEO_I8[:-1]):
            out["n8"][fi, 0, sl] = gd[f]
        out["n8"][5, 0, sl] = 1                        # valid
        out["digits"][0, sb:sb + gd["slen"]] = gd["digits"]
        out["loc"][0, sl] = gd["ndx"]
        out["lslen"][0, sl] = gd["slen"]
        out["blo"][k] = sb
        out["bhi"][k] = sb + gd["slen"]
        out["nbound"][k] = nb
        last_ndx = (int(gd["ndx"][nn - 1]) + sb) if nn else last_ndx
        nreg = -(-nn // tile) * tile
        pad = slice(nb + nn, nb + nreg)
        out["n32"][0, 0, pad] = last_ndx               # monotonic dup
        out["n32"][2, 0, pad] = np.arange(nb + nn, nb + nreg)
        nb += nreg
        sb += (gd["slen"] + 383) // 384 * 384 + 384
    out["n32"][0, 0, nb:] = last_ndx
    out["n32"][2, 0, nb:] = np.arange(nb, NT)
    out["nbound"][C2:] = nb
    out["slen"][0] = sb
    assert nb <= NT and sb <= SB
    return out


# --------------------------------------------------------------------------
# the fused scoring + DP launch
# --------------------------------------------------------------------------

def _seg_comb(a, b):
    """Segmented-running-max combine: (m, r) pairs, r = "reset seen"."""
    (m1, r1), (m2, r2) = a, b
    return jnp.where(r2, m2, jnp.maximum(m1, m2)), r1 | r2


def _seg_scan_incl(m, r):
    """Inclusive (m, r) scan along axis 1: associative_scan for short
    axes; for long axes (Mbp contigs) a BLOCKED formulation — intra-block
    associative_scan over a fixed 1024 window plus a tiny `lax.scan` of
    block carries.  `associative_scan` at n ~ 10^5 compiles slowly (its
    unrolled log-depth slicing tree grows with n); the blocked form
    bounds it at identical results."""
    BT, n, C = m.shape
    BK = 1024
    if n <= 4 * BK:
        return jax.lax.associative_scan(_seg_comb, (m, r), axis=1)
    NEGI = jnp.float32(-3e38)
    npad = (-n) % BK
    mp = jnp.pad(m, ((0, 0), (0, npad), (0, 0)), constant_values=NEGI)
    rp = jnp.pad(r, ((0, 0), (0, npad), (0, 0)))
    nb = (n + npad) // BK
    mb = mp.reshape(BT, nb, BK, C)
    rb = rp.reshape(BT, nb, BK, C)
    im, ir = jax.lax.associative_scan(_seg_comb, (mb, rb), axis=2)

    # block-carry pass: an associative_scan over the nb block summaries
    # (log-depth, fully parallel) instead of an nb-step sequential lax.scan
    bm_i, br_i = jax.lax.associative_scan(
        _seg_comb, (im[:, :, -1], ir[:, :, -1]), axis=1)   # inclusive
    # exclusive prefix: shift right with the identity as the seed
    pm = jnp.concatenate(
        [jnp.full((BT, 1, C), NEGI), bm_i[:, :-1]], axis=1)[:, :, None, :]
    pr = jnp.concatenate(
        [jnp.zeros((BT, 1, C), bool), br_i[:, :-1]], axis=1)[:, :, None, :]
    om = jnp.where(ir, im, jnp.maximum(pm, im))
    orr = pr | ir
    return (om.reshape(BT, nb * BK, C)[:, :n],
            orr.reshape(BT, nb * BK, C)[:, :n])


def _seg_scan(values, is_elem, is_reset, reset_val, init, reverse):
    """Segmented running-max scan along axis 1.

    values/is_elem/is_reset: (BT, n, C); init: (BT, C) seed state applied
    before (after, if reverse) the scanned axis.  Returns (inclusive,
    exclusive, final) scans of shape (BT, n, C) / (BT, C)."""
    NEGI = jnp.float32(-3e38)
    m = jnp.where(is_reset, jnp.float32(reset_val),
                  jnp.where(is_elem, values, NEGI))
    r = is_reset
    if reverse:
        m = jnp.flip(m, axis=1)
        r = jnp.flip(r, axis=1)

    ms, rs = _seg_scan_incl(m, r)
    # apply the seed (a reset-state prefix): comb(seed, x)
    seed = init[:, None, :]
    incl = jnp.where(rs, ms, jnp.maximum(seed, ms))
    excl = jnp.concatenate([jnp.broadcast_to(seed, seed.shape[:1] + (1,)
                                             + seed.shape[2:]),
                            incl[:, :-1]], axis=1)
    final = incl[:, -1]
    if reverse:
        incl = jnp.flip(incl, axis=1)
        excl = jnp.flip(excl, axis=1)
    return incl, excl, final


def _phase_cumsum(x):
    """Per-phase (mod-3) inclusive prefix sums along axis 1 of a (B, S)
    array, S a multiple of 3: out[b, p] = sum of x[b, q] over q <= p with
    q % 3 == p % 3."""
    B, S = x.shape
    return jnp.cumsum(x.reshape(B, S // 3, 3), axis=1).reshape(B, S)


def _sel_phase(scan, phase):
    """Pick each node's own channel from a (BT, n, 3) scan."""
    return jnp.where(phase == 0, scan[..., 0],
                     jnp.where(phase == 1, scan[..., 1], scan[..., 2]))


def _row_lookup_small(rows, idx, K):
    """``rows[b, idx[b, n]]`` for a small per-item table (K <= ~32) as a
    one-hot contraction (exact: one nonzero product per output; whether
    a plain gather is faster on the card is ROADMAP D1)."""
    oh = jax.nn.one_hot(idx, K, dtype=rows.dtype)
    return jnp.einsum("bnk,bk->bn", oh, rows,
                      precision=jax.lax.Precision.HIGHEST)


def _gat(a, idx):
    return jnp.take_along_axis(a, idx, axis=1)


def _lookup64_shared(T, codes, chunk=32768):
    """Geometry-shared table lookup ``T[b, codes[j]] -> (BT, n)`` for a
    (BT, 4096) table and a SHARED (n,) code vector: the hi-bits one-hot is
    built once and contracted against every bin's table rows in a single
    (n, 64) x (64, BT*64) contraction — 16x less one-hot work than the
    per-row `_lookup64` when all batch rows share one geometry.  Chunked
    so the (BT, chunk, 64) row intermediate stays bounded."""
    BT = T.shape[0]
    Tr = T.reshape(BT, 64, 64)
    n = codes.shape[0]

    def one(c):
        oh_hi = jax.nn.one_hot(c >> 6, 64, dtype=T.dtype)    # (k, 64)
        rows = jnp.einsum("nh,bhl->bnl", oh_hi, Tr,
                          precision=jax.lax.Precision.HIGHEST)
        oh_lo = jax.nn.one_hot(c & 63, 64, dtype=T.dtype)
        return jnp.sum(rows * oh_lo[None], axis=2)           # (BT, k)

    if n <= chunk:
        return one(codes)
    nc = -(-n // chunk)
    cp = jnp.pad(codes, (0, nc * chunk - n)).reshape(nc, chunk)
    out = jax.lax.map(one, cp)                               # (nc, BT, chunk)
    return out.transpose(1, 0, 2).reshape(BT, nc * chunk)[:, :n]


def _lookup64_flat(T, flat):
    """One-chunk core of `_lookup64`: flat codes of shape (BT, K)."""
    hi = flat >> 6
    lo = flat & 63
    Tr = T.reshape(T.shape[0], 64, 64)
    oh_hi = jax.nn.one_hot(hi, 64, dtype=T.dtype)
    rows = jnp.einsum("bkh,bhl->bkl", oh_hi, Tr,
                      precision=jax.lax.Precision.HIGHEST)
    oh_lo = jax.nn.one_hot(lo, 64, dtype=T.dtype)
    return jnp.sum(rows * oh_lo, axis=2)


def _lookup64(T, codes, chunk=262144):
    """Batched table lookup `T[b, codes[b, ...]]` for (BT, 4096) tables as
    two 64-way one-hot contractions (hi bits pick a row, lo bits select
    within it; ROADMAP D1 weighs it against a plain gather).  Exact: each
    one-hot row has a single 1, so the f32 contraction reproduces the
    table value bit-for-bit.  Finiteness precondition:
    every table entry must be finite — the contraction computes 0*x for
    non-selected entries, so an inf/NaN sentinel anywhere in a table would
    poison every lookup (BinTables holds only finite log-weights).

    Code sets wider than `chunk` (Mbp-scale contigs) stream through
    `lax.map` so the transient one-hot stays bounded."""
    BT = T.shape[0]
    shp = codes.shape
    flat = codes.reshape(BT, -1)
    K = flat.shape[1]
    if K <= chunk:
        return _lookup64_flat(T, flat).reshape(shp)
    nc = -(-K // chunk)
    KP = nc * chunk
    flatp = jnp.pad(flat, ((0, 0), (0, KP - K)))
    chunks = flatp.reshape(BT, nc, chunk).transpose(1, 0, 2)
    out = jax.lax.map(lambda c: _lookup64_flat(T, c), chunks)
    return out.transpose(1, 0, 2).reshape(BT, KP)[:, :K].reshape(shp)



def _derive_m6(geo):
    """On-device 6-mer code arrays (G, S) from the digit sequences, with
    mer_ndx semantics (N folds to C; reference: _sequence.h mer_ndx)."""
    d = geo["digits"].astype(jnp.int32)                # (G, S)
    G, S = d.shape
    b = d & 3
    bc = jnp.where(d < 4, 3 - b, 2)
    bp = jnp.pad(b, ((0, 0), (0, 6)))
    bcp = jnp.pad(bc, ((0, 0), (6, 0)))
    m6f = sum((bp[:, k:k + S] << (2 * k)) for k in range(6))
    m6r = sum((bcp[:, 6 - k:6 - k + S] << (2 * k)) for k in range(6))
    pos = jax.lax.broadcasted_iota(jnp.int32, (G, S), 1)
    if "blo" in geo:
        # packed multi-contig geometry: zero m6r outside every contig's
        # [blo, bhi) range (the gap/pad regions), reproducing the
        # per-contig beyond-slen clipping
        inc = jnp.zeros((G, S), bool)
        C2 = geo["blo"].shape[0]
        for c in range(C2):
            inc = inc | ((pos >= geo["blo"][c]) & (pos < geo["bhi"][c]))
        m6r = jnp.where(inc, m6r, 0)
    else:
        m6r = jnp.where(pos < geo["slen"][:, None], m6r, 0)
    return m6f, m6r




def _oh_pick(oh, blocks):
    """One-hot super-block selection with EXACT integer values: the
    12-bit 6-mer codes are split into two 6-bit halves (exact in
    bfloat16), contracted in one bf16 pass each and recombined —
    bit-identical to a HIGHEST-precision f32 contraction (every output
    sums exactly one product of a 0/1 weight and a value < 64)."""
    bhi = jnp.floor(blocks * (1.0 / 64.0))
    blo = blocks - bhi * 64.0
    ohb = oh.astype(jnp.bfloat16)
    Rhi = jnp.einsum("gnq,gqc->gnc", ohb, bhi.astype(jnp.bfloat16))
    Rlo = jnp.einsum("gnq,gqc->gnc", ohb, blo.astype(jnp.bfloat16))
    return Rhi.astype(F32) * 64.0 + Rlo.astype(F32)


def _window_gather(a, start, L):
    """``out[g, n, w] = a[g, start[g, n] + w]`` for w in [0, L), with reads
    outside [0, S) returning 0.

    One coarse one-hot block contraction picks each window's 256-wide
    aligned super-block, then log2(128) masked rolls align the residual
    offset (ROADMAP D1 weighs it against a plain gather).  Requires ``start >= -128``,
    ``start + L < S + 256``, ``L <= 128``, and S a multiple of 128."""
    G, S = a.shape
    assert S % 128 == 0 and L <= 128
    ap = jnp.pad(a.astype(F32), ((0, 0), (128, 384)))
    nblk = S // 128 + 3
    blocks = jnp.concatenate(
        [ap[:, :nblk * 128].reshape(G, nblk, 128),
         ap[:, 128:128 + nblk * 128].reshape(G, nblk, 128)], axis=2)
    q = (start + 128) >> 7
    r = (start + 128) & 127
    oh = jax.nn.one_hot(q, nblk, dtype=F32)            # (G, n, nblk)
    R = _oh_pick(oh, blocks)
    for bit in (64, 32, 16, 8, 4, 2, 1):
        R = jnp.where((r & bit)[..., None] != 0,
                      jnp.roll(R, -bit, axis=2), R)
    return R[:, :, :L]


def _window_gather_tiled(a, start, ok, L, node_tile=2048, SW=131072):
    """`_window_gather` for Mbp-scale sequences: the (G, n, nblk) one-hot
    of the plain formulation would scale with S, so the node axis is tiled
    (nodes are sorted by position, so a tile of `node_tile` consecutive
    nodes spans a bounded sequence range — the host geometry check
    guarantees span + window <= `SW`).  Each tile dynamically slices its
    local (SW + 384)-wide sequence segment and runs the same block
    one-hot + masked-roll gather against it.

    `ok` masks real nodes; rows with ok=False produce arbitrary in-range
    garbage (callers mask downstream)."""
    G, S = a.shape
    _, n = start.shape
    T = node_tile
    assert n % T == 0 and SW % 128 == 0
    nt = n // T
    SWW = SW + 384
    ap = jnp.pad(a.astype(F32), ((0, 0), (128, SWW)))
    stt = start.reshape(G, nt, T).transpose(1, 0, 2)       # (nt, G, T)
    okt = ok.reshape(G, nt, T).transpose(1, 0, 2)
    base = jnp.min(jnp.where(okt, stt, 2 ** 30), axis=2)   # (nt, G)
    base = jnp.clip(jnp.where(base == 2 ** 30, 0, base), -128, S)
    nblk = SWW // 128 - 1

    def tile_fn(xs):
        st_t, b_t = xs                                     # (G, T), (G,)
        # local segment: seg[k] = a[b + k]  (ap front-padded by 128)
        seg = jax.vmap(
            lambda row, b: jax.lax.dynamic_slice(row, (b + 128,), (SWW,))
        )(ap, b_t)
        l = jnp.clip(st_t - b_t[:, None], 0, SW - 1)
        blocks = jnp.concatenate(
            [seg[:, :nblk * 128].reshape(G, nblk, 128),
             seg[:, 128:128 + nblk * 128].reshape(G, nblk, 128)], axis=2)
        q = l >> 7
        r = l & 127
        oh = jax.nn.one_hot(q, nblk, dtype=F32)
        R = _oh_pick(oh, blocks)
        for bit in (64, 32, 16, 8, 4, 2, 1):
            R = jnp.where((r & bit)[..., None] != 0,
                          jnp.roll(R, -bit, axis=2), R)
        return R[:, :, :L]

    out = jax.lax.map(tile_fn, (stt, base))                # (nt, G, T, L)
    return out.transpose(1, 0, 2, 3).reshape(G, n, L)


# motif-candidate slot constants (reference: lib.pyx:1556-1616 scan order:
# motif length 6..3 = i 3..0, then 13 window positions ascending)
def _motif_slots():
    o = np.zeros(52, np.int32)
    sp = np.zeros(52, np.int32)
    ln = np.zeros(52, np.int32)
    for i in range(3, -1, -1):
        for s in range(13):
            off = s - 18 - i
            if off <= -16 - i:
                spc = 3
            elif off <= -14 - i:
                spc = 2
            elif off >= -7 - i:
                spc = 1
            else:
                spc = 0
            slot = (3 - i) * 13 + s
            o[slot], sp[slot], ln[slot] = off, spc, i
    return o, sp, ln


_MOT_O, _MOT_SP, _MOT_LEN = _motif_slots()


def _derive_candidates(geo, m6f, m6r, sd_ex, sd_mm, has_nonsd):
    """Per-geometry candidate tensors, all on device (validated against the
    C precompute rc_rbs_candidates/rc_ups_mers/rc_motif_candidates).

    Every candidate position is a constant offset from the node start, so
    each node needs only two contiguous 6-mer-code windows — upstream on
    the coding strand ([ndx-48, ndx+3) of m6f) and downstream of the
    mirror ([ndx+1, ndx+49) of m6r) — fetched once with `_window_gather`;
    all SD / upstream / motif candidate mers are then constant slices of
    those windows (no per-element gathers)."""
    g_ndx = geo["n32"][0]                              # (G, n)
    n8 = geo["n8"].astype(jnp.int32)
    g_typ, g_strand, g_edge = n8[0], n8[1], n8[2]
    G, n = g_ndx.shape
    fwd = (g_strand == 1)[..., None]
    is_start = (g_typ != STOP)[..., None]
    not_edge = (g_edge == 0)[..., None]
    nd = g_ndx[..., None]
    # validity masks use LOCAL (per-contig) coordinates; for a packed
    # multi-contig geometry these are shipped per node, otherwise they
    # coincide with the global ones
    if "loc" in geo:
        loc = geo["loc"][..., None]                    # (G, n, 1)
        lsl = geo["lslen"][..., None]
    else:
        loc = nd
        lsl = jnp.broadcast_to(geo["slen"][:, None, None], nd.shape)

    # m6r is zeroed beyond slen, so overflowing reverse-strand reads see
    # code 0 exactly like the clipped-index formulation they replace.
    #
    # Contigs with node-free gaps (giant N runs) ship a gap-compacted
    # digit array + compact node coordinates for the WINDOW reads only —
    # every candidate window lies within +-54 bp of its node, so
    # collapsing node-free stretches preserves every window byte while
    # bounding the per-node-tile sequence span (the dc prefix sums stay
    # on the full sequence).
    if "cdigits" in geo:
        m6wf, m6wr = _derive_m6(
            {"digits": geo["cdigits"], "slen": geo["c_slen"]})
        w_ndx = geo["c_ndx"]
    else:
        m6wf, m6wr = m6f, m6r
        w_ndx = g_ndx
    S = m6wf.shape[1]
    if S > 262144 or n > 16384:
        g_ok = geo["n8"][5] != 0
        Wf = _window_gather_tiled(m6wf, w_ndx - 48, g_ok, 51
                                  ).astype(jnp.int32)
        Wr = _window_gather_tiled(m6wr, w_ndx + 1, g_ok, 48
                                  ).astype(jnp.int32)
    else:
        Wf = _window_gather(m6wf, w_ndx - 48, 51).astype(jnp.int32)
        Wr = _window_gather(m6wr, w_ndx + 1, 48).astype(jnp.int32)

    # SD candidate codes over the 15 window positions: position p reads
    # the 6-mer at ndx-20+p (fwd; window lane 28+p) / ndx+20-p (rev;
    # lane 19-p).  The per-bin winner tables (BinTables.sd_wi) are looked
    # up per position in _score_items; here only the geometry-shared
    # codes and validity are derived.
    p = jnp.arange(15)[None, None, :]
    idx = jnp.where(fwd, loc - 20 + p, loc + 20 - p)
    ok = (idx >= 0) & is_start & not_edge
    code = jnp.where(fwd, Wf[:, :, 28:43], Wr[:, :, 5:20][:, :, ::-1])
    del sd_ex, sd_mm

    # upstream-composition mers: slots 0-1 = -1,-2; 2-31 = -15..-44
    # (fwd lane 48-k of Wf; rev lane k-1 of Wr)
    ks = jnp.asarray(np.array([1, 2] + list(range(15, 45)),
                              np.int32))[None, None, :]
    start_coord = jnp.where(fwd, loc, lsl - 1 - loc)
    uok = (ks <= start_coord) & is_start
    umer_f = jnp.concatenate(
        [Wf[:, :, 46:48][:, :, ::-1], Wf[:, :, 4:34][:, :, ::-1]], axis=2)
    umer_r = jnp.concatenate(
        [Wr[:, :, 0:2], Wr[:, :, 14:44]], axis=2)
    umer = jnp.where(fwd, umer_f, umer_r) & 3
    ups_flat = jnp.where(uok, jnp.arange(32)[None, None, :] * 4 + umer, 0)

    mot = None
    if has_nonsd:
        o = jnp.asarray(_MOT_O)[None, None, :]
        mok = (start_coord + o >= 0) & is_start & not_edge
        # slot group for motif length i+3: fwd lanes [30-i, 43-i) of Wf,
        # rev lanes [5+i, 18+i) of Wr reversed
        mers = []
        for i in range(3, -1, -1):
            mf = Wf[:, :, 30 - i:43 - i]
            mr = Wr[:, :, 5 + i:18 + i][:, :, ::-1]
            mers.append(jnp.where(fwd, mf, mr)
                        & ((1 << (2 * (i + 3))) - 1))
        mmer = jnp.concatenate(mers, axis=2)
        mot = jnp.where(
            mok,
            jnp.asarray(_MOT_LEN)[None, None, :] * 16384
            + jnp.asarray(_MOT_SP)[None, None, :] * 4096 + mmer,
            -1)

    return code, ok, ups_flat, uok, mot


def star_pointers(ndx, typ, strand, stop_val, valid, edge, cs_tot, rsc, usc,
                  stw, relk, max_overlap):
    """Overlapping-start pointers, flag=1 (reference: lib.pyx:2279-2329):
    for every stop node and frame, the node index of the best-scoring
    start that overlaps it, or -1.  All inputs are (BT, n) except stw
    (BT, 1); cs_tot = cscore + sscore.  Returns (3, BT, n) int32."""
    # Replay the global-running-max scan over the candidate windows (the
    # scan's node-index span is bounded; prepare_geometry verified it fits
    # `relk`).  Candidates are derived on device: for a forward stop the
    # scan walks j = i+3 down, for a reverse stop j = i-3 up, masked by the
    # reference's geometric conditions.  The running max is shared across
    # frames, as in the reference.
    BT, n = cs_tot.shape
    iidx = jnp.arange(n)[None, :]
    stop = (typ == STOP) & (valid != 0)
    fwd = strand == 1
    edgeb = edge != 0
    fstop = stop & fwd & ~edgeb
    rstop = stop & ~fwd & ~edgeb
    runmax = jnp.full((BT, n), -100.0, F32)
    ptr = [jnp.full((BT, n), -1, jnp.int32) for _ in range(3)]
    ndx_i, rsc_i, usc_i = ndx, rsc, usc
    mo = max_overlap

    def sh(a, d):
        """a[:, i+d] at column i (wrap-around is masked by the j bounds)."""
        return jnp.roll(a, -d, axis=1)

    # The candidate j is always within `relk` node indices of the stop i
    # (prepare_geometry verified the span), so each scan step is a fixed
    # SHIFT of the node tensors — forward stops walk j = i+3-k, reverse
    # stops j = i+k-3 — rather than a general gather.  The
    # two stop populations occupy disjoint columns, so the two scans fold
    # into one fori_loop (steps t < relk sweep forward stops, t >= relk
    # reverse stops) with column-disjoint runmax updates — identical
    # results to two sequential unrolled loops, at 1/64th the HLO size.
    def star_body(t, carry):
        runmax, p0, p1, p2 = carry
        is_f = t < relk
        k = jnp.where(is_f, t, t - relk)
        d = jnp.where(is_f, 3 - k, k - 3)
        j = iidx + d
        ndx_j = sh(ndx, d)
        sc_j = sh(cs_tot, d)
        rsc_j = sh(rsc, d)
        usc_j = sh(usc, d)
        typ_j = sh(typ, d)
        str_j = sh(strand, d)
        sv_j = sh(stop_val, d)
        val_j = sh(valid, d)
        okd = jnp.where(
            is_f,
            fstop & (str_j == 1) & (ndx_j <= ndx + 2)
            & (ndx_j + mo >= ndx) & (sv_j > ndx),
            rstop & (str_j == -1) & (ndx_j >= ndx - 2)
            & (ndx_j - mo <= ndx) & (sv_j < ndx))
        # intergenic modifier runs gene-before -> gene-after: for a forward
        # stop the candidate start j is downstream (i -> j), for a reverse
        # stop upstream (j -> i)
        igm = dp_pallas._igm_same(
            jnp.where(is_f, ndx_i, ndx_j),
            jnp.where(is_f, strand, -1),
            jnp.where(is_f, rsc_i, rsc_j),
            jnp.where(is_f, usc_i, usc_j),
            jnp.where(is_f, ndx_j, ndx_i),
            jnp.where(is_f, rsc_j, rsc_i),
            jnp.where(is_f, usc_j, usc_i), stw)
        ok = (j >= 0) & (j < n) & (val_j != 0) & (typ_j != STOP) & okd
        sc = sc_j + igm
        upd = ok & (sc > runmax)
        phj = ndx_j % 3
        p0 = jnp.where(upd & (phj == 0), j, p0)
        p1 = jnp.where(upd & (phj == 1), j, p1)
        p2 = jnp.where(upd & (phj == 2), j, p2)
        return jnp.where(upd, sc, runmax), p0, p1, p2

    runmax, *ptr = jax.lax.fori_loop(
        0, 2 * relk, star_body, (runmax, ptr[0], ptr[1], ptr[2]))

    return jnp.stack(ptr)                          # (3, BT, n)


def _score_items(tables, geo, bin_idx, gidx, *, is_meta, closed, S3,
                 has_nonsd, relk, max_overlap):
    """Compute cscore/sscore/rscore/uscore and star pointers for a batch of
    (contig, bin) work items (reference: lib.pyx:2119-2487, 2279-2329)."""
    (gene_dc, rbs_wt, ups_comp, type_wt, mot_wt, st_wt_t, no_mot_t,
     uses_sd_t, log_ns_t, lfmin_t, lfmax_t, sd_ex, sd_mm,
     sd_wi) = tables

    n32 = jnp.take(geo["n32"], gidx, axis=1)           # (3, BT, n)
    ndx, stop_val, win_lo = (n32[k] for k in range(3))
    n8 = jnp.take(geo["n8"], gidx, axis=1).astype(jnp.int32)
    typ, strand, edge, stop_real, euf, valid = (n8[k] for k in range(6))
    BT, n = ndx.shape

    m6f, m6r = _derive_m6(geo)
    g_code, g_ok, g_ups_flat, g_uok, g_mot = _derive_candidates(
        geo, m6f, m6r, sd_ex, sd_mm, has_nonsd)

    stw = st_wt_t[bin_idx][:, None]                    # (BT, 1)
    if "loc" in geo:
        # packed multi-contig geometry: per-node local coordinates and
        # contig lengths replace the per-geometry slen in every
        # slen-dependent rule (broadcast (1, n) against (BT, n))
        loc = geo["loc"]
        slen = geo["lslen"]
    else:
        loc = ndx
        slen = jnp.take(geo["slen"], gidx)[:, None]    # (BT, 1) int
    slen_f = slen.astype(F32)
    start = (typ != STOP) & (valid != 0)
    stop = (typ == STOP) & (valid != 0)
    fwd = strand == 1
    phase = ndx % 3
    edgeb = edge != 0

    # ---- cscore pass 1: hexamer sums as phase-wise prefix differences ----
    dcrow = gene_dc[bin_idx]                           # (BT, 4096)
    S = m6f.shape[1]
    if m6f.shape[0] == 1:
        # shared geometry (mega): a column gather of the one code row
        dcf = jnp.take(dcrow, m6f[0], axis=1)
        dcr = jnp.take(dcrow, m6r[0], axis=1)
    else:
        m6 = jnp.take(jnp.stack([m6f, m6r]), gidx, axis=1)
        dcf = _lookup64(dcrow, m6[0])
        dcr = _lookup64(dcrow, m6[1])
    Cf = _phase_cumsum(dcf)
    Cr = _phase_cumsum(dcr)

    if n > 16384:
        # mega route: every row shares the single geometry, so the four
        # prefix reads collapse to per-position ROW gathers (contiguous
        # row DMA, ~6x faster than per-element gathers).  The forward
        # side reads Cf[p-3] (clamped; every p-3 < 0 use is masked by
        # the caller), the reverse side Cr[p].  Gathering from the two
        # (S, BT) transposes separately keeps the peak footprint ~2.5 GB
        # lower than a fused (S, 2BT) table on Mbp-scale contigs.
        CfT = Cf.T
        CrT = Cr.T

        def duo(p):
            j0 = p[0]
            f = jnp.take(CfT, jnp.clip(j0 - 3, 0, S - 1), axis=0)
            r = jnp.take(CrT, jnp.clip(j0, 0, S - 1), axis=0)
            return f.T, r.T

        f_ndx, r_ndx = duo(ndx)
        f_sv, r_sv = duo(stop_val)
        cs1_f = (jnp.where(stop_val - 3 >= 0, f_sv, 0.0)
                 - jnp.where(ndx - 3 >= 0, f_ndx, 0.0))
        cs1_r = (jnp.where(ndx >= 0, r_ndx, 0.0)
                 - jnp.where(stop_val >= 0, r_sv, 0.0))
    else:
        def pref(C, j):
            return jnp.where(j >= 0, _gat(C, jnp.clip(j, 0, S - 1)), 0.0)

        cs1_f = pref(Cf, stop_val - 3) - pref(Cf, ndx - 3)
        cs1_r = pref(Cr, ndx) - pref(Cr, stop_val)
    cscore = jnp.where(start, jnp.where(fwd, cs1_f, cs1_r), 0.0)

    # ---- pass 2: ascending-coding penalty (segmented running max) --------
    ph1 = jax.nn.one_hot(phase, 3, dtype=bool)         # (BT, n, 3)
    neg1e4 = jnp.full((BT, 3), -1e4, F32)

    def chan(pred):
        return pred[..., None] & ph1

    v_c = jnp.broadcast_to(cscore[..., None], (BT, n, 3))
    inc_f, _, fin2f = _seg_scan(v_c, chan(start & fwd), chan(stop & fwd),
                                -1e4, neg1e4, False)
    inc_r, _, fin2r = _seg_scan(v_c, chan(start & ~fwd), chan(stop & ~fwd),
                                -1e4, neg1e4, True)
    run2 = jnp.where(fwd, _sel_phase(inc_f, phase), _sel_phase(inc_r, phase))
    cscore = jnp.where(start, 2.0 * cscore - run2, cscore)

    # ---- pass 3: length factor (carries pass-2 scan state, as the
    # reference does: lib.pyx:2119-2239 keeps one running score[3]) --------
    log_ns = log_ns_t[bin_idx][:, None]
    lfmin = lfmin_t[bin_idx][:, None]
    lfmax = lfmax_t[bin_idx][:, None]
    orf_len = jnp.abs(ndx - stop_val)
    gsize = (orf_len.astype(F32) + 3.0) / 3.0
    tmp = jnp.exp(gsize * log_ns)
    lfac_raw = jnp.where(
        gsize > 1000.0,
        (lfmax - lfmin) * (gsize - 80.0) / 920.0,
        jnp.log1p(-tmp) - gsize * log_ns - lfmin,
    )
    v_l = jnp.broadcast_to(lfac_raw[..., None], (BT, n, 3))
    inc3f, exc3f, fin3f = _seg_scan(v_l, chan(start & fwd),
                                    chan(stop & fwd), -1e4, fin2r, False)
    _, exc3r, _ = _seg_scan(v_l, chan(start & ~fwd), chan(stop & ~fwd),
                            -1e4, fin3f, True)
    run3 = jnp.where(fwd, _sel_phase(exc3f, phase), _sel_phase(exc3r, phase))
    lfac = jnp.where(
        lfac_raw > run3, lfac_raw,
        lfac_raw - jnp.maximum(jnp.minimum(run3 - lfac_raw, lfac_raw), 0.0))
    cfix = jnp.where((lfac > 3.0) & (cscore < 0.5 * lfac), 0.5 * lfac,
                     cscore)
    cscore = jnp.where(start, cfix + lfac, cscore)

    # ---- RBS / SD score ---------------------------------------------------
    # Per window position, gather the per-bin winner-index PAIR (exact /
    # 1-mismatch packed as ex*32+mm) from the precomputed (15, 4096)
    # tables (BinTables.sd_wi) and take the index max over positions —
    # the reference's per-position running-max + cross-position index-max
    # rule (lib.pyx:2241-2277) without the 27-step weight sweep over
    # (BT, n, 15) masks.  With a shared geometry (mega launches) the
    # one-hot is built once per position and contracted against every
    # bin's table in one contraction.
    rbs_row = rbs_wt[bin_idx]                          # (BT, 28)
    wi_row = sd_wi[bin_idx]                            # (BT, 15, 4096)
    shared = g_code.shape[0] == 1
    if not shared:
        code_g = jnp.take(g_code, gidx, axis=0)        # (BT, n, 15)
        ok_g = jnp.take(g_ok, gidx, axis=0)
    rbs0 = jnp.zeros((BT, n), jnp.int32)
    rbs1 = jnp.zeros((BT, n), jnp.int32)
    for p in range(15):
        if shared:
            vp = _lookup64_shared(wi_row[:, p], g_code[0, :, p])
            okp = g_ok[0:1, :, p]
        else:
            vp = _lookup64(wi_row[:, p], code_g[:, :, p])
            okp = ok_g[:, :, p]
        # unpack (exact in f32: vp <= 27*32+27, /32 is a power-of-two
        # scale, so floor/sub reproduce the integer pair bit-for-bit)
        w0p = jnp.floor(vp * (1.0 / 32.0))
        w1p = (vp - w0p * 32.0).astype(jnp.int32)
        w0p = w0p.astype(jnp.int32)
        rbs0 = jnp.maximum(rbs0, jnp.where(okp, w0p, 0))
        rbs1 = jnp.maximum(rbs1, jnp.where(okp, w1p, 0))
    w0 = _row_lookup_small(rbs_row, rbs0, 28)
    w1 = _row_lookup_small(rbs_row, rbs1, 28)
    sd_score = jnp.maximum(w0, w1) * stw

    if has_nonsd:
        mid = jnp.take(g_mot, gidx, axis=0)            # (BT, n, 52)
        # group the 52 slots by their constant (len, spc) pair: each group
        # reads one 4096-wide sub-table of mot_wt through the one-hot
        # contraction; the running max over slots is value-only, so group
        # order does not change the result
        mer = mid & 4095
        groups = {}
        for s in range(52):
            ls = int(_MOT_LEN[s]) * 4 + int(_MOT_SP[s])
            groups.setdefault(ls, []).append(s)
        mrow16 = mot_wt[bin_idx].reshape(BT, 16, 4096)
        best = jnp.full((BT, n), -100.0, F32)
        for ls, slots in sorted(groups.items()):
            codes = jnp.stack([mer[:, :, s] for s in slots], axis=2)
            vals = _lookup64(mrow16[:, ls], codes)     # (BT, n, len(slots))
            ok = jnp.stack([mid[:, :, s] >= 0 for s in slots], axis=2)
            gmax = jnp.max(jnp.where(ok, vals, -100.0), axis=2)
            best = jnp.maximum(best, gmax)
        no_mot = no_mot_t[bin_idx][:, None]
        mot_sc = jnp.where((best == -4.0) | (best < no_mot + 0.69),
                           no_mot, best)
        r_nonsd = stw * mot_sc
        # non-SD mode never runs the SD scan, so its fallback compares
        # against rbs_wt[0] (rbs0 = rbs1 = 0 in the reference)
        sd0 = jnp.broadcast_to(rbs_row[:, 0:1] * stw, r_nonsd.shape)
        r_nonsd = jnp.where((r_nonsd < sd0) & (no_mot > -0.5),
                            sd0, r_nonsd)
        rscore = jnp.where(uses_sd_t[bin_idx][:, None] != 0,
                           sd_score, r_nonsd)
    else:
        rscore = sd_score

    # ---- upstream composition -------------------------------------------
    # Per geometry, count how many valid slots hit each of the 128 table
    # cells; the per-item score is then one contraction of the count
    # matrix against every bin's ups_comp row, after which each work item
    # just picks its (geometry, bin) row.
    G = g_ups_flat.shape[0]
    NBINS = ups_comp.shape[0]

    def ups_body(k, counts):
        code = jax.lax.dynamic_index_in_dim(g_ups_flat, k, axis=2,
                                            keepdims=False)
        okk = jax.lax.dynamic_index_in_dim(g_uok, k, axis=2,
                                           keepdims=True)
        # bfloat16 accumulator on purpose: per-cell counts are <= 32,
        # exactly representable, and the (G, n, 128) buffer is the
        # scoring pipeline's biggest single tensor on Mbp contigs
        oh = jax.nn.one_hot(code, 128, dtype=jnp.bfloat16)
        return counts + jnp.where(okk, oh, jnp.bfloat16(0))

    counts = jax.lax.fori_loop(
        0, 32, ups_body,
        jnp.zeros(g_ups_flat.shape[:2] + (128,), jnp.bfloat16))
    u_all = jnp.einsum("gnc,Bc->gBn", counts.astype(F32), ups_comp,
                       precision=jax.lax.Precision.HIGHEST)
    u_base = jnp.take(u_all.reshape(G * NBINS, n),
                      gidx * NBINS + bin_idx, axis=0) * (0.4 * stw)

    # ---- start score assembly (reference: lib.pyx:2331-2487) -------------
    edge0 = edge + (1 - stop_real)
    tw = type_wt[bin_idx]                              # (BT, 3)
    tw_n = jnp.where(typ == 0, tw[:, 0:1],
                     jnp.where(typ == 1, tw[:, 1:2], tw[:, 2:3]))
    tsc = jnp.where(edgeb, EDGE_BONUS * stw / edge0.astype(F32),
                    tw_n * stw)
    rsc = jnp.where(edgeb, 0.0, rscore)
    usc = jnp.where(edgeb, 0.0, u_base + jnp.where(euf != 0,
                                                   EDGE_UPS * stw, 0.0))
    mut = ((not closed) & ~edgeb & start
           & (((loc <= 2) & fwd) | ((loc >= slen - 3) & ~fwd)))
    edge_gene = edge0 + mut.astype(jnp.int32)
    egf = edge_gene.astype(F32)
    tsc = jnp.where(mut, 0.0, tsc)
    usc = jnp.where(mut, EDGE_BONUS * stw / jnp.maximum(egf, 1.0), usc)
    rsc = jnp.where(mut, 0.0, rsc)
    edge_eff = edgeb | mut
    usc = usc - jnp.where(~edge_eff & (edge_gene == 1),
                          0.5 * EDGE_BONUS * stw, 0.0)
    small = (edge_gene == 0) & (orf_len < 250)
    negf = 250.0 / jnp.maximum(orf_len.astype(F32), 1.0)
    posf = orf_len.astype(F32) / 250.0

    def scale(x):
        return jnp.where(small, x * jnp.where(x < 0, negf, posf), x)

    tsc, rsc, usc = scale(tsc), scale(rsc), scale(usc)
    if is_meta:
        pen = (slen < 3000) & (edge_gene == 0) & ((cscore < 5.0)
                                                  | (orf_len < 120))
        cscore = jnp.where(
            start & pen,
            cscore - META_PEN * jnp.maximum(
                0.0, (3000.0 - slen_f) / 2700.0),
            cscore)
    ssc = tsc + rsc + usc
    csneg = cscore < 0.0
    b1 = csneg & (edge_gene > 0) & ~edge_eff
    if is_meta:
        pen1 = jnp.where(slen > 1500, stw, 10.31 - 0.004 * slen_f)
    else:
        pen1 = jnp.broadcast_to(stw, b1.shape)
    ssc = jnp.where(b1, ssc - pen1, ssc)
    if is_meta:
        b2 = csneg & ~b1 & (slen < 3000) & edge_eff
        kill = b2 & (orf_len.astype(F32) >= jnp.sqrt(slen_f) * 5.0)
        ssc = jnp.where(kill, 0.0, ssc)
        usc = jnp.where(kill, 0.0, usc)
        b3 = csneg & ~b1 & ~b2
    else:
        b3 = csneg & ~b1
    ssc = jnp.where(b3, ssc - 0.5, ssc)
    if is_meta:
        b4 = (~csneg & (cscore < 5.0) & (orf_len < 120) & (ssc < 0.0))
        ssc = jnp.where(b4, ssc - stw, ssc)

    # stops carry no start scores
    tsc = jnp.where(start, tsc, 0.0)
    rsc = jnp.where(start, rsc, 0.0)
    usc = jnp.where(start, usc, 0.0)
    ssc = jnp.where(start, ssc, 0.0)
    cscore = jnp.where(valid != 0, cscore, 0.0)

    star_ptr = star_pointers(ndx, typ, strand, stop_val, valid, edge,
                             cscore + ssc, rsc, usc, stw, relk, max_overlap)
    return (ndx, stop_val, typ, strand, win_lo, valid,
            cscore, ssc, rsc, usc, star_ptr, stw[:, 0])


_LAUNCH_STATIC = ("is_meta", "closed", "S3", "has_nonsd", "relk",
                  "max_overlap")


@functools.partial(jax.jit, static_argnames=_LAUNCH_STATIC + (
    "lookback", "interpret"))
def score_dp_launch(tables, geo, bin_idx, gidx, *, is_meta, closed, S3,
                    has_nonsd, relk, max_overlap, lookback, interpret=False):
    """Fused on-device scoring + DP for one launch of work items (a
    geometry per row).  Returns (score, traceb, ov_mark, best): the DP
    state in node coordinates and the per-item best terminal path score —
    all device-resident."""
    geo = _unpack_geo(geo)
    (ndx, stop_val, typ, strand, win_lo, valid,
     cscore, ssc, rsc, usc, star_ptr, stw) = _score_items(
        tables, geo, bin_idx, gidx, is_meta=is_meta, closed=closed,
        S3=S3, has_nonsd=has_nonsd, relk=relk, max_overlap=max_overlap)
    return dp_pallas.dp_core(
        ndx, stop_val, typ, strand, win_lo, valid, cscore + ssc, rsc, usc,
        star_ptr, stw, lookback=lookback, interpret=interpret)


def pack_winners(best):
    """Per-item best path scores, bitcast for one tiny pull.

    The device sweep is the bin FILTER: the host picks each contig's
    winning bin from these scores (first-max in bin order, reproducing
    the reference's sequential `score > max_score` sweep,
    lib.pyx:5363-5365) and re-runs the exact f64 C DP for that bin — so
    emitted genes are byte-exact by construction.  Bins whose device
    scores sit within the f32 drift margin of the winner are arbitrated
    by the exact engine too (TpuMetaRunner._produce_winner)."""
    return jax.lax.bitcast_convert_type(best, jnp.int32)


@functools.partial(jax.jit, static_argnames=_LAUNCH_STATIC + (
    "lookback", "interpret"))
def score_dp_launch_packed(tables, geo, bin_idx, gidx, *, is_meta, closed,
                           S3, has_nonsd, relk, max_overlap, lookback,
                           interpret=False):
    """`score_dp_launch` + per-item best-score packing: one launch, one
    (BT,) bitcast result, one tiny device->host pull."""
    *_, best = score_dp_launch(
        tables, geo, bin_idx, gidx, is_meta=is_meta, closed=closed, S3=S3,
        has_nonsd=has_nonsd, relk=relk, max_overlap=max_overlap,
        lookback=lookback, interpret=interpret)
    return pack_winners(best)


@functools.partial(jax.jit, static_argnames=_LAUNCH_STATIC + (
    "lookback", "fxs", "interpret"))
def score_dp_mega(tables, geo, bin_idx, gidx, *, is_meta, closed, S3,
                  has_nonsd, relk, max_overlap, lookback, fxs=dp_pallas.FXS,
                  interpret=False):
    """Fused scoring + DP over ONE shared geometry with the candidate-bin
    union as rows: one Mbp-scale contig, or a PACK of contigs laid
    end-to-end on the node + sequence axes (geo carries "loc"/"lslen"/
    "blo"/"bhi"/"nbound", built by pack_geometries_multi).  bin_idx has
    BT rows (bins, padded).  Returns (score, traceb, ov_mark, best) with
    best (BT,) for one contig or (CP, BT) for a pack."""
    geo = _unpack_geo(geo)
    (ndx, stop_val, typ, strand, win_lo, valid,
     cscore, ssc, rsc, usc, star_ptr, stw) = _score_items(
        tables, geo, bin_idx, gidx, is_meta=is_meta, closed=closed,
        S3=S3, has_nonsd=has_nonsd, relk=relk, max_overlap=max_overlap)
    return dp_pallas.dp_core(
        ndx[0:1], stop_val[0:1], typ[0:1], strand[0:1], win_lo[0:1],
        valid[0:1], cscore + ssc, rsc, usc, star_ptr, stw,
        lookback=lookback, fxs=fxs, interpret=interpret,
        node_bounds=geo.get("nbound"))


@functools.partial(jax.jit, static_argnames=_LAUNCH_STATIC + (
    "lookback", "fxs", "interpret"))
def score_dp_launch_mega(tables, geo, bin_idx, gidx, **kwargs):
    """`score_dp_mega` + best-score packing: the bitcast best scores
    (padded rows/slots yield garbage scores the caller ignores)."""
    *_, best = score_dp_mega(tables, geo, bin_idx, gidx, **kwargs)
    return pack_winners(best)


@functools.partial(jax.jit, static_argnames=_LAUNCH_STATIC)
def score_only(tables, geo, bin_idx, gidx, *, is_meta, closed, S3,
               has_nonsd, relk=32, max_overlap=60):
    """Scoring without the DP — for differential tests vs the C engine."""
    geo = _unpack_geo(geo)
    return _score_items(tables, geo, bin_idx, gidx, is_meta=is_meta,
                        closed=closed, S3=S3, has_nonsd=has_nonsd,
                        relk=relk, max_overlap=max_overlap)
