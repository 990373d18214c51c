#!/usr/bin/env python3
"""Smoke test of the device path on a GPU.

Runs the product's main path once at real genome sizes, through the entry
points a user calls, and checks every result against the exact float64 C
engine (`backend="refcore"`, the repository's plain reference):

1. kernels: a batched launch (128 rows, node bucket 3072) and a mega
   launch (the 2.46 Mbp genome, 16 rows) — every row's best path score
   against refcore's f64 path score (within the runner's bin-arbitration
   margin) and against the plain `dp_jax` scan;
2. meta mode: `GeneFinder(meta=True, backend="jax").find_genes_batch` on
   the four in-repo genomes plus seeded 2-45 kb cuts of them — GFF and
   protein FASTA byte-equal to refcore, both launch routes used, no
   contig on the host fallback;
3. single mode: `train` + `find_genes(backend="jax")`, plain and with
   closed ends and masking, byte-equal to refcore;
4. the CLI, `-p meta --backend jax`, byte-equal to `--backend refcore`.

With --multi it runs only the sharded runner on four GPUs against the
one-GPU runner and refcore, and `train_distributed` against `train`.

The last line of standard output is the verdict, e.g.
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}
Any failure raises.  Without a GPU it exits non-zero and prints no
verdict.  Usage:

    python3 chip_smoke.py [--multi] [--seed N] [--only PHASE ...]
"""

import argparse
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")
GENOMES = (
    "GCF_001457455.1_NCTC11397_genomic.fna.gz",        # 2.46 Mbp
    "MIIJ01000039.fna.gz",                             # N-runs
    "GCF_001457455.1_NCTC11397_genomic_100kb.fna.gz",
    "SRR492066.fna.gz",
)
N_CUTS = 72
PHASES = ("kernels", "meta", "single", "cli")
COMPILE = {"s": 0.0, "n": 0}


def log(*args):
    print(*args, flush=True)


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def on_duration(event, duration, **_kw):
    if event == "/jax/core/compile/backend_compile_duration":
        COMPILE["s"] += duration
        COMPILE["n"] += 1


def load_genomes():
    from pyrodigal_tpu.fasta import parse

    return [(name.split(".fna")[0], list(parse(os.path.join(DATA, name)))[0]
             .seq) for name in GENOMES]


def seeded_cuts(genomes, seed, n=N_CUTS):
    """n distinct contigs of 2-45 kb cut at seeded positions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cuts, seen = [], set()
    while len(cuts) < n:
        gi = int(rng.integers(len(genomes)))
        name, seq = genomes[gi]
        length = int(rng.integers(2000, 45001))
        if length >= len(seq):
            continue
        start = int(rng.integers(0, len(seq) - length))
        if (gi, start) in seen:
            continue
        seen.add((gi, start))
        cuts.append((f"{name}_{start}_{length}", seq[start:start + length]))
    return cuts


def timed(fn, *args, **kwargs):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


# --------------------------------------------------------------------------
# 1. kernels at real widths
# --------------------------------------------------------------------------

def ref_best(runner, seq, nodes_by_tt, b):
    """refcore's float64 best path score for one (contig, bin)."""
    nodes = runner._score_winner(seq, nodes_by_tt, b)
    ipath = nodes.dynamic_programming(runner.bins[b].training_info,
                                      final=True)
    if nodes.length == 0 or ipath < 0:
        return -1.0
    return float(nodes.score[ipath])


@functools.lru_cache(maxsize=None)
def _dp_jax_rows(lookback, shared):
    """The plain `dp_jax` scan vmapped over rows, jitted once per shape
    family; returns each row's best terminal path score."""
    import jax
    import jax.numpy as jnp
    from pyrodigal_tpu._constants import STOP
    from pyrodigal_tpu.ops import dp_jax

    def one(ndx, sv, typ, strand, win_lo, valid, cs, rsc, usc, sp, stw):
        valid = valid != 0
        score, _, _ = dp_jax.dp_scores(
            ndx, sv, typ, strand, cs, rsc, usc, sp.T, win_lo, valid, stw,
            W=lookback)
        term = valid & (((strand == 1) & (typ == STOP))
                        | ((strand != 1) & (typ != STOP)))
        return jnp.max(jnp.where(term, score, -1.0))

    geo_axis = None if shared else 0
    return jax.jit(jax.vmap(one, in_axes=(geo_axis,) * 6 + (0, 0, 0, 1, 0)))


def dp_jax_best(scored, lookback, shared):
    """Per-row best terminal path score of the plain `dp_jax` scan on a
    launch's own scored nodes (`score_device.score_only` output)."""
    (ndx, stop_val, typ, strand, win_lo, valid,
     cscore, ssc, rsc, usc, star_ptr, stw) = scored
    geom = (ndx, stop_val, typ, strand, win_lo, valid)
    if shared:
        geom = tuple(a[0] for a in geom)
    return _dp_jax_rows(lookback, shared)(*geom, cscore + ssc, rsc, usc,
                                          star_ptr, stw)


def check_launch(name, runner, launch, args, kwargs, rows, shared):
    """Compile one launch, compare every real row, time the DP stage.
    rows: [(seq, nodes_by_tt, bin_id)] for the leading real rows."""
    import numpy as np
    import jax
    from pyrodigal_tpu.ops import dp_pallas, score_device as sd

    t0 = time.perf_counter()
    compiled = launch.lower(*args, **kwargs).compile()
    log(f"[{name}] compile {time.perf_counter() - t0:.1f} s; "
        f"memory_analysis: {compiled.memory_analysis()}")
    timed(compiled, *args)
    (*_, best), t_launch = timed(compiled, *args)
    best = np.asarray(best).reshape(-1)
    assert np.all(np.isfinite(best)), f"{name}: non-finite best scores"

    static = {k: kwargs[k] for k in ("is_meta", "closed", "S3", "has_nonsd",
                                     "relk", "max_overlap")}
    scored = sd.score_only(*args, **static)
    lookback = kwargs["lookback"]
    timed(dp_jax_best, scored, lookback, shared)
    jb, t_jax = timed(dp_jax_best, scored, lookback, shared)
    jb = np.asarray(jb)

    geo_rows = slice(0, 1) if shared else slice(None)
    dp_args = tuple(a[geo_rows] for a in scored[:6]) + (
        scored[6] + scored[7], scored[8], scored[9], scored[10], scored[11])
    dp_kw = dict(lookback=lookback, fxs=kwargs.get("fxs", dp_pallas.FXS),
                 interpret=kwargs["interpret"])
    dp_fn = jax.jit(lambda *a: dp_pallas.dp_core(*a, **dp_kw)[3])
    timed(dp_fn, *dp_args)
    _, t_dp = timed(dp_fn, *dp_args)

    dev_ref = dev_jax = 0.0
    for r, (seq, nbt, b) in enumerate(rows):
        ref = ref_best(runner, seq, nbt, b)
        margin = runner._margin(ref)
        d_ref = abs(best[r] - ref)
        d_jax = abs(best[r] - jb[r])
        assert d_ref <= margin, (
            f"{name} row {r} (bin {b}): device {best[r]} vs refcore {ref}")
        assert d_jax <= margin, (
            f"{name} row {r} (bin {b}): device {best[r]} vs dp_jax {jb[r]}")
        dev_ref = max(dev_ref, d_ref)
        dev_jax = max(dev_jax, d_jax)
    log(f"[{name}] {len(rows)} rows of {best.size} within the margin "
        f"1+1e-4*|best|: max |device - refcore f64| = {dev_ref:.6g}, "
        f"max |device - dp_jax| = {dev_jax:.6g}")
    log(f"[{name}] time: launch (scoring + DP) {t_launch * 1e3:.2f} ms; "
        f"DP stage: Pallas kernel {t_dp * 1e3:.2f} ms, "
        f"plain dp_jax scan {t_jax * 1e3:.2f} ms")


def time_replaced(args, kwargs):
    """XLA times, at the mega launch's shapes, of the scoring stages that
    run without a hand kernel: the star sweep + star tables, the phase
    cumsum and the dc-table gather + phase cumsum."""
    import jax
    import jax.numpy as jnp
    from pyrodigal_tpu.ops import dp_pallas, score_device as sd

    static = {k: kwargs[k] for k in ("is_meta", "closed", "S3", "has_nonsd",
                                     "relk", "max_overlap")}
    (ndx, stop_val, typ, strand, win_lo, valid,
     cscore, ssc, rsc, usc, _sp, stw) = sd.score_only(*args, **static)
    geo = sd._unpack_geo(args[1])
    edge = jnp.broadcast_to(geo["n8"][2].astype(jnp.int32), ndx.shape)
    relk, mo = kwargs["relk"], kwargs["max_overlap"]

    @jax.jit
    def star(ndx, typ, strand, stop_val, valid, edge, cs, rsc, usc, stw):
        sp = sd.star_pointers(ndx, typ, strand, stop_val, valid, edge, cs,
                              rsc, usc, stw[:, None], relk, mo)
        return sp, dp_pallas.star_tables(ndx, strand, stop_val, cs, rsc,
                                         usc, sp, stw)

    star_args = (ndx, typ, strand, stop_val, valid, edge, cscore + ssc,
                 rsc, usc, stw)
    timed(star, *star_args)
    _, t_star = timed(star, *star_args)

    m6f, m6r = sd._derive_m6(geo)
    dcrow = args[0][0][args[2]]

    @jax.jit
    def dc(dcrow, m6f, m6r):
        return (sd._phase_cumsum(jnp.take(dcrow, m6f[0], axis=1)),
                sd._phase_cumsum(jnp.take(dcrow, m6r[0], axis=1)))

    @jax.jit
    def cumsum(x):
        return sd._phase_cumsum(x)

    timed(dc, dcrow, m6f, m6r)
    (cf, _), t_dc = timed(dc, dcrow, m6f, m6r)
    timed(cumsum, cf)
    _, t_cum = timed(cumsum, cf)
    log(f"[mega] XLA time: star sweep + tables {t_star * 1e3:.2f} ms "
        f"({tuple(ndx.shape)}); dc gather + 2 phase cumsums "
        f"{t_dc * 1e3:.2f} ms; one phase cumsum {t_cum * 1e3:.2f} ms "
        f"({tuple(cf.shape)})")


def phase_kernels(bins, genomes, cuts):
    from pyrodigal_tpu.sequence import Sequence
    from pyrodigal_tpu.ops import score_device as sd
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    runner = TpuMetaRunner(bins)
    # batched launch: fill 128 rows with std-route cuts
    work, geoms, rows = [], {}, []
    for ci, (_name, s) in enumerate(cuts):
        seq = Sequence(s)
        cand, g, nbt, route = runner._prepare_contig(seq)
        tts = {bins[b].training_info.translation_table for b in cand}
        if (route != "std" or not cand
                or len(work) + len(cand) > runner.batch_size
                or len(geoms) + len(tts) > runner.max_geoms):
            continue
        for b in cand:
            key = (ci, bins[b].training_info.translation_table)
            geoms.setdefault(key, g[key[1]])
            work.append((ci, b, key))
            rows.append((seq, nbt, b))
    assert len(work) > runner.batch_size // 2, "too few std rows"
    args, kwargs = runner._std_launch(work, geoms)
    check_launch("std", runner, sd.score_dp_launch, args, kwargs, rows,
                 shared=False)

    # mega launch: the 2.46 Mbp genome, its candidate bins as rows
    seq = Sequence(genomes[0][1])
    cand, g, nbt, route = runner._prepare_contig(seq)
    assert route == "mega" and len(g) == 1, route
    args, kwargs, brows, _cp, B = runner._mega_launch(
        [{"ci": 0, "g": next(iter(g.values())), "rows": cand}])
    log(f"[mega] {g[next(iter(g))]['nn']} nodes, {B} rows "
        f"({len(brows)} bins)")
    check_launch("mega", runner, sd.score_dp_mega, args, kwargs,
                 [(seq, nbt, b) for b in brows], shared=True)
    time_replaced(args, kwargs)


# --------------------------------------------------------------------------
# 2-4. end to end
# --------------------------------------------------------------------------

def render(results, names):
    """GFF and protein FASTA text of a batch."""
    gff, faa = io.StringIO(), io.StringIO()
    for genes, name in zip(results, names):
        genes.write_gff(gff, name)
        genes.write_translations(faa, name)
    return gff.getvalue(), faa.getvalue()


def assert_same(what, got, want, names, against="refcore"):
    for part, g, w in zip(("GFF", "protein FASTA"), got, want):
        if g != w:
            gl, wl = g.splitlines(), w.splitlines()
            first = next((i for i, (a, b) in enumerate(zip(gl, wl))
                          if a != b), min(len(gl), len(wl)))
            raise AssertionError(
                f"{what}: {part} differs from {against} at line {first}: "
                f"{gl[first:first + 1]} vs {wl[first:first + 1]}")
    log(f"[{what}] {len(names)} contigs: GFF ({len(got[0])} bytes) and "
        f"protein FASTA ({len(got[1])} bytes) byte-equal to {against}")


def phase_meta(genomes, cuts, card):
    from pyrodigal_tpu import GeneFinder

    contigs = genomes + cuts
    names = [n for n, _ in contigs]
    seqs = [s for _, s in contigs]
    finder = GeneFinder(meta=True, backend="jax")
    c0 = dict(COMPILE)
    t0 = time.perf_counter()
    out = finder.find_genes_batch(seqs)
    warm = time.perf_counter() - t0
    routes = dict(finder._meta_runner.route_counts)
    log(f"[meta] routes: {routes}")
    assert routes.get("std", 0) >= 1 and routes.get("mega", 0) >= 1, routes
    assert routes.get("c", 0) == 0, routes
    ref = GeneFinder(meta=True, backend="refcore").find_genes_batch(seqs)
    assert_same("meta", render(out, names), render(ref, names), names)
    t0 = time.perf_counter()
    finder.find_genes_batch(seqs)
    dt = time.perf_counter() - t0
    bp = sum(len(s) for s in seqs)
    log(f"[meta] warm-up {warm:.1f} s, of which compile "
        f"{COMPILE['s'] - c0['s']:.1f} s in {COMPILE['n'] - c0['n']} "
        f"programs; timed pass {dt:.2f} s over {bp} bp = "
        f"{bp / dt / 1e6:.3f} Mbp/s on {card} (information, not a claim)")


def phase_single(genomes):
    import warnings
    from pyrodigal_tpu import GeneFinder

    name, seq = genomes[0]
    for kw in ({}, {"closed": True, "mask": True}):
        finder = GeneFinder(backend="jax", **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tinf = finder.train(seq)
        got = render([finder.find_genes(seq)], [name])
        want = render([GeneFinder(tinf, backend="refcore", **kw)
                       .find_genes(seq)], [name])
        assert_same(f"single {kw or 'plain'}", got, want, [name])


def phase_cli():
    from pyrodigal_tpu.cli import main

    path = os.path.join(DATA, GENOMES[1])
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("refcore", "jax"):
            faa = os.path.join(tmp, f"{backend}.faa")
            stdout, stderr = io.StringIO(), io.StringIO()
            stdin = io.StringIO()
            stdin.isatty = lambda: True
            rc = main(["-i", path, "-p", "meta", "--backend", backend,
                       "-a", faa], stdout=stdout, stderr=stderr,
                      stdin=stdin)
            assert rc == 0, stderr.getvalue()
            with open(faa) as f:
                outs[backend] = (stdout.getvalue(), f.read())
    assert_same("cli -p meta --backend jax", outs["jax"], outs["refcore"],
                [path])


def phase_multi(bins, genomes, cuts):
    import warnings
    import jax
    from pyrodigal_tpu import GeneFinder
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner
    from pyrodigal_tpu.parallel import make_mesh, train_distributed

    assert len(jax.devices()) >= 4, jax.devices()
    mesh = make_mesh(4)
    contigs = genomes + cuts
    names = [n for n, _ in contigs]
    seqs = [s for _, s in contigs]
    sharded = TpuMetaRunner(bins, mesh=mesh)
    t0 = time.perf_counter()
    got = render(sharded.find_genes_batch(seqs), names)
    log(f"[multi] sharded runner {time.perf_counter() - t0:.1f} s, routes "
        f"{dict(sharded.route_counts)}")
    one = render(TpuMetaRunner(bins).find_genes_batch(seqs), names)
    assert_same("multi", got, one, names, against="the one-GPU runner")
    ref = render(GeneFinder(meta=True, backend="refcore")
                 .find_genes_batch(seqs), names)
    assert_same("multi", got, ref, names)
    seq = genomes[0][1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = GeneFinder(backend="refcore").train(seq)
    tinf = train_distributed(mesh, seq)
    assert bytes(tinf.raw) == bytes(want.raw), "train_distributed differs"
    log("[multi] train_distributed bit-equal to GeneFinder.train")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-GPU sharded runner check")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the contig cuts")
    parser.add_argument("--only", choices=PHASES, action="append",
                        help="run only these one-GPU phases")
    args = parser.parse_args()

    sys.path.insert(0, HERE)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    try:
        from pyrodigal_tpu.ops.platform import use_compile_cache
        from pyrodigal_tpu.metagenomic import METAGENOMIC_BINS
    except ImportError as err:
        print(f"chip_smoke: pyrodigal_tpu not found beside the script "
              f"({err})", file=sys.stderr)
        return 1
    cache = use_compile_cache(HERE)
    jax.monitoring.register_event_duration_secs_listener(on_duration)
    cards = card_lines()
    log(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
        f"{len(devices)} devices; compile cache {cache}")
    assert len(METAGENOMIC_BINS) > 0, "metagenomic bins asset missing"

    genomes = load_genomes()
    cuts = seeded_cuts(genomes, args.seed)
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(METAGENOMIC_BINS, genomes, cuts[:16])
    else:
        only = args.only or PHASES
        if "kernels" in only:
            phase_kernels(METAGENOMIC_BINS, genomes, cuts)
        if "meta" in only:
            phase_meta(genomes, cuts, cards[0])
        if "single" in only:
            phase_single(genomes)
        if "cli" in only:
            phase_cli()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s; compile "
        f"{COMPILE['s']:.1f} s in {COMPILE['n']} programs")
    for line in cards:
        log(line)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
