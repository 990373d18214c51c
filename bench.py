"""Benchmark driver: meta-mode gene-calling throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mbp/s", "vs_baseline": N, ...}

Workload: natural, UNCHOPPED contigs called in metagenomic mode (the
~13-bin GC-window sweep per contig) — a 2.46 Mbp complete genome, a
404 kb contig, a 100 kb contig and an 80 kb contig, six replicas each
(~21 Mbp total; enough work for the device pipeline to reach steady
state).  Nothing is sliced to dodge device limits: Mbp-scale
contigs take the "mega" route (one shared geometry, bins as rows), smaller
ones the bucketed batch route; no contig takes the host C fallback.  The baseline is the reference's best published CPU
throughput (2.149 Mbp/s, single mode, 1 core — see BASELINE.md; the
reference's meta mode is ~10x slower per bp than its single mode, so
this denominator is conservative).

Warmup compiles one program per (node, sequence) bucket combination; the
persistent compilation cache (JAX_COMPILATION_CACHE_DIR if set, else
.jax_cache/ in the checkout) amortizes this across runs.  Exits non-zero
without a GPU: a CPU run would time the interpreter, not the device.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HERE = os.path.dirname(os.path.abspath(__file__))

BASELINE_MBPS = 2.149  # reference pyrodigal, sse backend, 1 CPU core

DATA_DIRS = [
    "/root/reference/src/pyrodigal/tests/data",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data"),
]

WORKLOAD = [
    "GCF_001457455.1_NCTC11397_genomic.fna.gz",       # 2.46 Mbp genome
    "MIIJ01000039.fna.gz",                            # ~404 kb contig
    "GCF_001457455.1_NCTC11397_genomic_100kb.fna.gz",  # 100 kb contig
    "SRR492066.fna.gz",                               # ~80 kb contig
]
REPLICAS = 6


def data(name):
    for d in DATA_DIRS:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(name)


def _stage_probe(finder, work):
    """One instrumented pass: aggregate wall seconds per pipeline stage
    (host prep, mega launch pack+dispatch, exact-C winner finishing)."""
    from pyrodigal_tpu.ops import meta_tpu

    agg = {"prep_s": 0.0, "dispatch_s": 0.0, "produce_s": 0.0}
    saved = {}

    def wrap(name, key):
        orig = getattr(meta_tpu.TpuMetaRunner, name)
        saved[name] = orig

        def timed(self, *a, **kw):
            t0 = time.time()
            out = orig(self, *a, **kw)
            agg[key] += time.time() - t0
            return out
        setattr(meta_tpu.TpuMetaRunner, name, timed)

    wrap("_prepare_contig", "prep_s")
    wrap("_sweep_mega_multi", "dispatch_s")
    wrap("_produce_winner", "produce_s")
    try:
        t0 = time.time()
        finder.find_genes_batch(work)
        agg["pass_s"] = time.time() - t0
    finally:
        for name, orig in saved.items():
            setattr(meta_tpu.TpuMetaRunner, name, orig)
    return {k: round(v, 3) for k, v in agg.items()}


def _card():
    """The GPU's name and power limit, as nvidia-smi reports them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def main():
    from pyrodigal_tpu.fasta import parse
    from pyrodigal_tpu import GeneFinder
    from pyrodigal_tpu.ops.platform import use_compile_cache

    import jax
    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench.py: no GPU (platform {device.platform!r})",
              file=sys.stderr)
        return 1
    cache_dir = use_compile_cache(HERE)
    cold_cache = not (os.path.isdir(cache_dir) and os.listdir(cache_dir))

    base = [r.seq for n in WORKLOAD for r in parse(data(n))]
    finder = GeneFinder(meta=True)
    work = base * REPLICAS

    # warmup on the FULL workload (the packed-launch buckets depend on
    # the whole batch, so warming a subset would leave compiles inside
    # the timed passes)
    t0 = time.time()
    warm = finder.find_genes_batch(work)
    warmup_s = time.time() - t0

    # timed run: natural contigs, unchopped; MEDIAN of three passes
    # (min/max are reported too)
    total_bp = sum(len(c) for c in work)
    times = []
    for _ in range(3):
        t0 = time.time()
        results = finder.find_genes_batch(work)
        times.append(time.time() - t0)
    n_genes = sum(len(g) for g in results)
    times.sort()
    elapsed = times[1]

    mbps = total_bp / elapsed / 1e6
    out = {
        "metric": "gene-calling throughput, meta mode, unchopped contigs,"
                  " one GPU",
        "value": round(mbps, 4),
        "unit": "Mbp/s",
        "vs_baseline": round(mbps / BASELINE_MBPS, 4),
        "platform": device.platform,
        "device_kind": device.device_kind,
        "device_count": len(jax.devices()),
        "card": _card(),
        "contigs": len(work),
        "total_bp": total_bp,
        "genes": n_genes,
        "elapsed_s": round(elapsed, 2),
        "elapsed_min_s": round(times[0], 2),
        "elapsed_max_s": round(times[-1], 2),
        "warmup_s": round(warmup_s, 2),
        "cold_cache": cold_cache,
        "warm_genes": sum(len(g) for g in warm),
        "stages": _stage_probe(finder, work),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
