"""Differential check: on-device per-bin scoring vs the exact C engine.

Runs on JAX's default platform (a GPU if present; set JAX_PLATFORMS=cpu
to force the CPU):

    python scripts/diff_score_device.py [FASTA name in tests/data]
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyrodigal_tpu.fasta import parse  # noqa: E402
from pyrodigal_tpu.metagenomic import METAGENOMIC_BINS  # noqa: E402
from pyrodigal_tpu.sequence import Sequence  # noqa: E402
from pyrodigal_tpu.nodes import Nodes  # noqa: E402
from pyrodigal_tpu.ops import score_device as sd  # noqa: E402
from pyrodigal_tpu.ops.platform import use_compile_cache  # noqa: E402

DATA = os.path.join(REPO, "tests", "data")


def main():
    use_compile_cache(REPO)
    which = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("-") else "SRR492066.fna.gz"
    rec = list(parse(os.path.join(DATA, which)))[0]
    seq = Sequence(rec.seq[:30000])

    tables = sd.BinTables(METAGENOMIC_BINS)
    low = min(0.65, 0.88495 * seq.gc - 0.0102337)
    high = max(0.35, 0.86596 * seq.gc + 0.1131991)
    cand = [i for i in range(len(METAGENOMIC_BINS))
            if low <= METAGENOMIC_BINS[i].training_info.gc <= high]
    print("candidate bins:", cand)
    tts = sorted({METAGENOMIC_BINS[b].training_info.translation_table
                  for b in cand})

    K = 24
    geoms = {}
    nodes_by_tt = {}
    for tt in tts:
        nodes = Nodes()
        nodes.extract(seq, translation_table=tt)
        nodes.sort()
        nodes_by_tt[tt] = nodes
        geoms[tt] = sd.prepare_geometry(seq, nodes, tt, False, 60, K)
        print(f"tt={tt} nn={nodes.length} star_overflow={geoms[tt]['star_overflow']}")

    n = 3072
    S = 30720
    G = len(tts)
    packed = sd.pack_geometries([geoms[tt] for tt in tts], G, n, S)
    gmap = {tt: i for i, tt in enumerate(tts)}

    BT = 16
    bin_idx = np.zeros(BT, np.int32)
    gidx = np.zeros(BT, np.int32)
    for k, b in enumerate(cand[:BT]):
        bin_idx[k] = b
        gidx[k] = gmap[METAGENOMIC_BINS[b].training_info.translation_table]

    geo = {k: jnp.asarray(v) for k, v in packed.items()}
    out = sd.score_only(tables.as_tuple(), geo, jnp.asarray(bin_idx),
                        jnp.asarray(gidx), is_meta=True, closed=False,
                        S3=S // 3, has_nonsd=tables.any_nonsd)
    (ndx, stop_val, typ, strand, win_lo, valid,
     cscore, ssc, rsc, usc, star_ptr, stw) = [np.asarray(x) for x in out]

    bad = 0
    for k, b in enumerate(cand[:BT]):
        ti = METAGENOMIC_BINS[b].training_info
        tt = ti.translation_table
        nodes = nodes_by_tt[tt].copy()
        nodes.reset_scores()
        nodes.score_nodes(seq, ti, closed=False, is_meta=True)
        nodes.record_overlapping_starts(ti, 1, 60)
        nn = nodes.length

        def cmp(name, dev, ref, atol=2e-3, rtol=2e-5):
            err = np.abs(dev[:nn] - ref[:nn])
            tol = atol + rtol * np.abs(ref[:nn])
            nb = int((err > tol).sum())
            if nb:
                i = int(np.argmax(err - tol))
                print(f"  bin {b} {name}: {nb}/{nn} mismatch, worst "
                      f"@{i}: dev={dev[i]:.6f} ref={ref[i]:.6f}")
            return nb

        e = 0
        e += cmp("cscore", cscore[k], nodes.cscore)
        e += cmp("sscore", ssc[k], nodes.sscore)
        e += cmp("rscore", rsc[k], nodes.rscore)
        e += cmp("uscore", usc[k], nodes.uscore)
        spd = star_ptr[:, k, :nn].T
        spr = nodes.star_ptr[:nn * 3].reshape(nn, 3)
        nb = int((spd != spr).sum())
        if nb:
            ij = np.argwhere(spd != spr)[0]
            print(f"  bin {b} star_ptr: {nb} mismatch, first @{tuple(ij)}: "
                  f"dev={spd[tuple(ij)]} ref={spr[tuple(ij)]}")
        e += nb
        if e == 0:
            print(f"  bin {b} (tt={tt}, sd={ti.uses_sd}): OK")
        bad += e
    print("TOTAL mismatches:", bad)


if __name__ == "__main__":
    main()
