"""The gene-path dynamic program as a Pallas kernel on the Triton route.

Design (see also dp_jax.py for the reference scan formulation):

* one program per ROW — a row is one (contig, metagenomic bin) work item
  — with the sequential node loop inside the program, so the loop never
  leaves the SM; rows are independent, so a launch fills one SM per row;
* every predecessor access is a contiguous `CW`-lane load of `[i-CW, i)`
  (or a further chunk for the giant-ORF window extension, reference:
  lib.pyx:1221-1233); the star-pointer operon/triple-overlap gathers of
  the reference (_connection.h:180-357) are folded into precomputed
  per-row tables (`star_tables`), and the one data-dependent gather
  (`ndx[traceb[j]]`) is replaced by a `tb_ndx` shadow row kept beside
  the traceback;
* the node's (strand, type) case is uniform across the program, so each
  step runs only its own case's scores and skip rules (`lax.switch`);
* rows are front-padded by the lookback so window loads never go out of
  range; step i stores column i and step i+1 reads it back, so a barrier
  separates the two on the card.

One kernel serves both launch routes: the bucketed batch route (a
geometry per row) and the mega route (one shared geometry, bins as rows,
several contigs packed end to end on the node axis).  Path scores
accumulate in int32 fixed point; the winning bin is re-run by the exact
float64 C engine, so the device scores only select bins.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .._constants import OPER_DIST, MAX_OPP_OVLP, STOP

NEG = np.float32(-1e30)
NEGF = float(np.float32(-1e30))

# Path scores accumulate in int32 FIXED POINT (score * FXS).  f32 adds lose
# ~1e-7 relative per step; absolute path scores on Mbp contigs reach 1e4-1e5,
# so f32 resolution (~0.01 there) approaches real connection-score deltas and
# flips near-tie tracebacks nondeterministically vs the f64 C anchor.  Fixed
# point makes every accumulation exact (per-edge quantization +-1/(2*FXS) is
# the only error, bounded and magnitude-independent), and integer compares
# give the reference's `>=`/last-wins relaxation exactly
# (_connection.h:135-139).  Range: |score| < 2^31/FXS = 1.05e6.
FXS = 2048
INT_NEG = -(2 ** 30)

# predecessor lanes loaded per window chunk (a power of two, as Triton
# blocks must be); the usual window [win_lo, i) spans <= 1000 nodes, so
# one chunk covers it and only giant ORFs loop
CW = 1024
# 8 warps beat 4 by 6-13% and 2 by ~35% at the smoke's shapes (PERF.md)
NUM_WARPS = 8


def _igm_same(ndx1, strand1, rsc1, usc1, ndx2, rsc2, usc2, st_wt):
    """Same-strand intergenic modifier (reference: _connection.h:52-78);
    shared by the DP kernel, the star tables and the star sweep."""
    dist = jnp.abs(ndx1 - ndx2)
    overlap = ndx1 + 2 * strand1 >= ndx2
    adjacent = (ndx1 + 2 == ndx2) | (ndx1 == ndx2 + 1)
    fwd = strand1 == 1
    r_n = jnp.where(fwd, rsc2, rsc1)
    u_n = jnp.where(fwd, usc2, usc1)
    rval = jnp.where(
        adjacent,
        jnp.where(r_n < 0, -r_n, 0.0) + jnp.where(u_n < 0, -u_n, 0.0),
        0.0,
    )
    far = dist > 3 * OPER_DIST
    operon = ((dist <= OPER_DIST) & ~overlap) | (dist * 4 < OPER_DIST)
    bonus = (2.0 - dist.astype(jnp.float32) / OPER_DIST) * 0.15 * st_wt
    return (rval + jnp.where(far, -0.15 * st_wt,
                             jnp.where(operon, bonus, 0.0))
            ).astype(jnp.float32)


def _quant(x, fxs):
    """Round-half-to-even of x * fxs as int32 (`jnp.round`, spelled with
    floor so that it lowers on the Triton route; exact for |x*fxs| <
    2^22, far above any connection score)."""
    y = x * fxs
    r = jnp.floor(y + 0.5)
    ri = r.astype(jnp.int32)
    tie_odd = ((r - y) == 0.5) & ((ri & 1) == 1)
    return jnp.where(tie_odd, ri - 1, ri)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

def _dp_kernel(  # noqa: C901
    nn_ref, stw_ref,
    ndx_ref, sv_ref, kind_ref, winlo_ref,
    cs_ref, rsc_ref, usc_ref,
    opv0_ref, opv1_ref, opv2_ref,
    v30_ref, v31_ref, v32_ref,
    tsv0_ref, tsv1_ref, tsv2_ref,
    tnd0_ref, tnd1_ref, tnd2_ref,
    _score0, _tb0, _ov0, _tn0,
    score_ref, tb_ref, ov_ref, tn_ref,
    *, PREF, MAX_CHUNKS, fxs, barrier,
):
    """One row.  Every ref is that row's 1-D slice of width PREF + n
    (geometry rows may be shared by all programs); columns are node
    indices shifted by the PREF-lane front pad.  kind: 0 fwd start, 1 fwd
    stop, 2 rev start, 3 rev stop, 4 padding.  The outputs alias
    pre-initialized (0, -1, -1, 0) baselines, which the pad lanes keep.

    A committed column i holds score (fixed point), traceback (node
    index, no pad), ov_mark frame and tb_ndx = ndx[traceback]."""
    st_wt = stw_ref[0]
    igm_diff = jnp.float32(-0.15) * st_wt
    lane = jax.lax.broadcasted_iota(jnp.int32, (CW,), 0)

    def step(ip):
        i_ndx = ndx_ref[ip]
        i_sv = sv_ref[ip]
        i_kind = kind_ref[ip]
        i_fr = i_ndx % 3
        win_lo = winlo_ref[ip] + PREF
        n_chunks = jnp.clip((ip - win_lo + CW - 1) // CW, 1, MAX_CHUNKS)

        def scan(case):
            """Best (value, column, ov frame, ndx) over the window, the
            last (largest) column winning ties, like the reference's `>=`
            relaxation under an ascending scan."""

            def chunk(c, carry):
                best, bestj, bestf, bestn = carry
                lo = ip - (c + 1) * CW
                sl = pl.ds(lo, CW)
                jp = lo + lane
                n1_ndx = ndx_ref[sl]
                n1_kind = kind_ref[sl]
                n1_tb = tb_ref[sl]
                okw = (jp >= win_lo) & (n1_kind != 4)
                cand, m = case(sl, n1_ndx, n1_kind, n1_tb, okw)
                ok_cand = cand > jnp.float32(NEGF / 2)
                total = jnp.where(
                    ok_cand,
                    score_ref[sl] + _quant(jnp.where(ok_cand, cand, 0.0),
                                           fxs),
                    INT_NEG)
                cmax = jnp.max(total)
                pick = jnp.max(jnp.where(total == cmax, lane, -1))
                # one packed reduction gives both the ov_mark frame m
                # (2 bits, biased +1) and the predecessor ndx (< 2^28)
                meta = jnp.max(jnp.where(lane == pick, n1_ndx * 4 + (m + 1),
                                         -1))
                upd = cmax > best
                return (jnp.where(upd, cmax, best),
                        jnp.where(upd, lo + pick - PREF, bestj),
                        jnp.where(upd, (meta & 3) - 1, bestf),
                        jnp.where(upd, meta >> 2, bestn))

            init = (jnp.int32(INT_NEG), jnp.int32(-1), jnp.int32(-1),
                    jnp.int32(0))
            return jax.lax.fori_loop(0, n_chunks, chunk, init)

        neg1 = jnp.full((CW,), -1, jnp.int32)

        def fwd_start(sl, n1_ndx, n1_kind, n1_tb, okw):
            # sources: fwd stops (intergenic) and rev starts (flat)
            f1_stop = n1_kind == 1
            ok = okw & (n1_tb != -1) & (
                (f1_stop & (n1_ndx + 2 < i_ndx))
                | ((n1_kind == 2) & (n1_ndx < i_ndx)))
            sc = jnp.where(
                f1_stop,
                _igm_same(n1_ndx, 1, rsc_ref[sl], usc_ref[sl], i_ndx,
                          rsc_ref[ip], usc_ref[ip], st_wt),
                igm_diff)
            return jnp.where(ok, sc, jnp.float32(NEGF)), neg1

        def fwd_stop(sl, n1_ndx, n1_kind, n1_tb, okw):
            # sources: same-frame fwd starts (gene) and fwd stops (operon
            # through the star table of this node's frame)
            f1_start = n1_kind == 0
            f1_stop = n1_kind == 1
            ok = okw & (i_sv < n1_ndx) & (
                (f1_start & (n1_ndx % 3 == i_fr))
                | (f1_stop & (n1_tb != -1)))
            opv = jax.lax.switch(i_fr, [lambda: opv0_ref[sl],
                                        lambda: opv1_ref[sl],
                                        lambda: opv2_ref[sl]])
            sc = jnp.where(f1_start, cs_ref[sl], opv)
            return jnp.where(ok, sc, jnp.float32(NEGF)), neg1

        def rev_start(sl, n1_ndx, n1_kind, n1_tb, okw):
            # sources: same-frame rev stops (gene) and fwd stops
            # (opposite-strand overlap)
            f1_stop = n1_kind == 1
            r1_stop = n1_kind == 3
            bnd = jnp.where(n1_tb == -1, 0, tn_ref[sl])
            ov_ok = (
                ((i_sv - 2) < (n1_ndx + 2))
                & ((n1_ndx + 2) - (i_sv - 2) + 1 < MAX_OPP_OVLP)
                & ((n1_ndx - i_sv) < (i_ndx - n1_ndx + 3))
                & ((n1_ndx - i_sv) < (i_sv - 3 - bnd))
            )
            ok = okw & (
                (r1_stop & (n1_ndx % 3 == i_fr) & (sv_ref[sl] > i_ndx))
                | (f1_stop & (n1_tb != -1) & ov_ok))
            cs_i = cs_ref[ip]
            sc = jnp.where(r1_stop, cs_i, cs_i + igm_diff)
            return jnp.where(ok, sc, jnp.float32(NEGF)), neg1

        def rev_stop(sl, n1_ndx, n1_kind, n1_tb, okw):
            # sources: fwd stops (intergenic or a triple overlap through
            # this node's recorded starts), rev starts (intergenic), rev
            # stops (operon through the star table)
            f1_stop = n1_kind == 1
            r1_start = n1_kind == 2
            r1_stop = n1_kind == 3
            bnd = jnp.where(n1_tb == -1, 0, tn_ref[sl])
            left = n1_ndx + 2
            right = i_ndx - 2
            bv = jnp.zeros((CW,), jnp.float32)
            bf = neg1
            tables = ((v30_ref, tsv0_ref, tnd0_ref),
                      (v31_ref, tsv1_ref, tnd1_ref),
                      (v32_ref, tsv2_ref, tnd2_ref))
            v3 = []
            for k, (v_ref, tsv_ref, tnd_ref) in enumerate(tables):
                v_i = v_ref[ip]
                sv_i3 = tsv_ref[ip]
                o = left - sv_i3 + 3
                vald = (
                    (o > 0) & (o < MAX_OPP_OVLP)
                    & (o < tnd_ref[ip] - left)
                    & (o < sv_i3 - bnd - 2)
                )
                better = vald & (v_i > bv)
                bv = jnp.where(better, v_i, bv)
                bf = jnp.where(better, k, bf)
                v3.append(v_i)
            f_sc = jnp.where(bf != -1, bv, igm_diff)
            n1_fr = n1_ndx % 3
            v3j = jnp.where(n1_fr == 0, v3[0],
                            jnp.where(n1_fr == 1, v3[1], v3[2]))
            igm_j_i = _igm_same(n1_ndx, -1, rsc_ref[sl], usc_ref[sl],
                                i_ndx, rsc_ref[ip], usc_ref[ip], st_wt)
            sc = jnp.where(f1_stop, f_sc, jnp.where(r1_start, igm_j_i, v3j))
            ok = okw & (
                (f1_stop & (n1_tb != -1) & (left < right))
                | (r1_start & (n1_tb != -1) & (n1_ndx < right))
                | (r1_stop & (sv_ref[sl] > i_ndx)))
            return (jnp.where(ok, sc, jnp.float32(NEGF)),
                    jnp.where(f1_stop, bf, -1))

        best, bestj, bestf, bestn = jax.lax.switch(
            i_kind, [lambda: scan(fwd_start), lambda: scan(fwd_stop),
                     lambda: scan(rev_start), lambda: scan(rev_stop)])
        # each column is committed once, over its (0, -1) baseline, so the
        # reference's `>=` relaxation against it is just best >= 0
        do = best >= 0
        score_ref[ip] = jnp.where(do, best, 0)
        tb_ref[ip] = jnp.where(do, bestj, -1)
        ov_ref[ip] = jnp.where(do, bestf, -1)
        tn_ref[ip] = jnp.where(do, bestn, 0)
        if barrier:
            # the next step's window loads read this column back
            plt.debug_barrier()

    def body(i, carry):
        ip = i + PREF
        jax.lax.cond(kind_ref[ip] != 4, step, lambda _ip: None, ip)
        return carry

    jax.lax.fori_loop(0, nn_ref[0], body, 0)


def _run_kernel(geom, rows, stw, nn, PREF, MAX_CHUNKS, fxs, interpret):
    """geom: 4 (G, NPAD) geometry rows (G = 1 shares one geometry across
    all programs, else G = R); rows: 15 (R, NPAD) per-row operands; stw:
    (R,) f32; nn: (R,) int32 node-loop trip counts."""
    R, NPAD = rows[0].shape
    shared = geom[0].shape[0] == 1
    gmap = (lambda r: (0, 0)) if shared else (lambda r: (r, 0))
    row_spec = pl.BlockSpec((None, NPAD), lambda r: (r, 0))
    one_spec = pl.BlockSpec((None, 1), lambda r: (r, 0))
    inits = (jnp.zeros((R, NPAD), jnp.int32),
             jnp.full((R, NPAD), -1, jnp.int32),
             jnp.full((R, NPAD), -1, jnp.int32),
             jnp.zeros((R, NPAD), jnp.int32))
    kernel = functools.partial(_dp_kernel, PREF=PREF, MAX_CHUNKS=MAX_CHUNKS,
                               fxs=fxs, barrier=not interpret)
    n_in = 2 + len(geom) + len(rows)
    return pl.pallas_call(
        kernel,
        grid=(R,),
        in_specs=([one_spec, one_spec]
                  + [pl.BlockSpec((None, NPAD), gmap) for _ in geom]
                  + [row_spec] * (len(rows) + len(inits))),
        out_specs=[row_spec] * 4,
        out_shape=[jax.ShapeDtypeStruct((R, NPAD), jnp.int32)] * 4,
        input_output_aliases={n_in + k: k for k in range(4)},
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="dp_rows",
    )(nn[:, None], stw[:, None], *geom, *rows, *inits)


# --------------------------------------------------------------------------
# trace-level entry: star tables, padding, launch, terminal reduction
# --------------------------------------------------------------------------

def star_tables(ndx, strand, stop_val, cs, rsc, usc, sp, st_wt):
    """The derived star-pointer tables, gathered per row at the recorded
    pointers sp (3, R, n): for each frame k, the operon score offered to a
    fwd stop (opv1), the triple-overlap / operon score of a rev stop (val3),
    and the pointed-to start's stop_val / ndx (t_sv / t_ndx).  Invalid
    pointers carry sentinels (NEG, -10^9, 0) instead of separate masks.
    Geometry rows may be (1, n) (shared) or (R, n)."""
    R, n = cs.shape
    stw = st_wt[:, None]

    def full(a):
        return jnp.broadcast_to(a, (R, n))

    ndx, strand, stop_val = full(ndx), full(strand), full(stop_val)
    opv1, val3, t_sv, t_ndx = [], [], [], []
    for k in range(3):
        spk = sp[k].astype(jnp.int32)
        okm = spk != -1
        idx = jnp.clip(spk, 0, n - 1)
        g_ndx, g_cs, g_rs, g_us, g_str, g_sv = (
            jnp.take_along_axis(a, idx, axis=1)
            for a in (ndx, cs, rsc, usc, strand, stop_val))
        opv1.append(jnp.where(okm, g_cs + _igm_same(
            ndx, strand, rsc, usc, g_ndx, g_rs, g_us, stw), NEG))
        val3.append(jnp.where(okm, g_cs + _igm_same(
            g_ndx, g_str, g_rs, g_us, ndx, rsc, usc, stw), NEG))
        t_sv.append(jnp.where(okm, g_sv, -(10 ** 9)))
        t_ndx.append(jnp.where(okm, g_ndx, 0))
    return opv1, val3, t_sv, t_ndx


def dp_core(ndx, stop_val, typ, strand, win_lo, valid, cs, rsc, usc, sp,
            st_wt, *, lookback, fxs=FXS, interpret=False, node_bounds=None):
    """Device DP over R rows.  Geometry (ndx, stop_val, typ, strand,
    win_lo, valid) is (G, n) with G = 1 (one geometry shared by every
    row: the mega route) or G = R; scores cs (= cscore + sscore), rsc, usc
    are (R, n); star pointers sp (3, R, n); st_wt (R,).  `lookback` bounds
    i - win_lo[i] (the caller's route check guarantees it).

    Returns (score, traceb, ov_mark, best) with the first three (R, n) in
    node coordinates and best the per-row best terminal path score — or,
    with `node_bounds` ((C+1,) node offsets of contigs packed end to end),
    the per-contig best as (C, R)."""
    R, n = cs.shape
    max_chunks = -(-lookback // CW)
    PREF = max_chunks * CW
    kind = 2 * (strand != 1).astype(jnp.int32) + (typ == STOP)
    kind4 = jnp.where(valid != 0, kind, 4)
    opv1, val3, t_sv, t_ndx = star_tables(ndx, strand, stop_val, cs, rsc,
                                          usc, sp, st_wt)

    def pad(a, fill=0):
        return jnp.pad(a, ((0, 0), (PREF, 0)), constant_values=fill)

    geom = (pad(ndx), pad(stop_val), pad(kind4, 4), pad(win_lo))
    rows = tuple([pad(a) for a in (cs, rsc, usc)]
                 + [pad(a, NEGF) for a in opv1]
                 + [pad(a, NEGF) for a in val3]
                 + [pad(a, -(10 ** 9)) for a in t_sv]
                 + [pad(a) for a in t_ndx])
    # node-loop trip count: one past the last real node of the row
    last = jnp.max(jnp.where(valid != 0, jnp.arange(n)[None, :] + 1, 0),
                   axis=1)
    nn = jnp.broadcast_to(last, (R,)).astype(jnp.int32)
    score_fx, traceb, ov, _ = _run_kernel(
        geom, rows, st_wt.astype(jnp.float32), nn, PREF, max_chunks, fxs,
        interpret)
    score = score_fx[:, PREF:].astype(jnp.float32) * (1.0 / fxs)
    traceb, ov = traceb[:, PREF:], ov[:, PREF:]
    # best terminal path score: max over valid 3'fwd / 5'rev nodes
    terminal = (valid != 0) & ((kind == 1) | (kind == 2))
    tscore = jnp.where(terminal, score, -1.0)
    if node_bounds is None:
        best = jnp.max(tscore, axis=1)
    else:
        iidx = jnp.arange(n)[None, :]
        best = jnp.stack([
            jnp.max(jnp.where((iidx >= node_bounds[c])
                              & (iidx < node_bounds[c + 1]), tscore, -1.0),
                    axis=1)
            for c in range(node_bounds.shape[0] - 1)])
    return score, traceb, ov, best
