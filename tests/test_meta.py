"""Meta-mode tests: C path machinery and the device-batched runner."""

import warnings

import pytest

from pyrodigal_tpu import GeneFinder, MetagenomicBins, METAGENOMIC_BINS
from pyrodigal_tpu.fasta import parse

needs_bins = pytest.mark.skipif(
    len(METAGENOMIC_BINS) == 0,
    reason="metagenomic bins asset not built (scripts/build_bins.py)",
)


@needs_bins
def test_meta_c_path(data):
    record = list(parse(data("SRR492066.fna.gz")))[0]
    p = GeneFinder(meta=True)
    genes = p.find_genes(record.seq)
    assert len(genes) > 0
    assert genes.metagenomic_bin is not None
    assert genes.training_info is genes.metagenomic_bin.training_info


@needs_bins
def test_meta_gc_window_filters_bins(data):
    record = list(parse(data("SRR492066.fna.gz")))[0]
    # low-GC contig: only low-GC bins should be considered
    p = GeneFinder(meta=True)
    genes = p.find_genes(record.seq)
    assert genes.metagenomic_bin.training_info.gc < 0.45


def test_empty_metagenomic_bins(data):
    record = list(parse(data("SRR492066.fna.gz")))[0]
    p = GeneFinder(meta=True, metagenomic_bins=MetagenomicBins())
    genes = p.find_genes(record.seq)
    assert len(genes) == 0
    assert genes.metagenomic_bin is None
    assert genes.training_info is None


@needs_bins
def test_custom_metagenomic_bins(data):
    record = list(parse(data("SRR492066.fna.gz")))[0]
    p0 = GeneFinder(meta=True)
    full = p0.find_genes(record.seq)
    chosen = full.metagenomic_bin
    sub = MetagenomicBins((chosen,))
    p1 = GeneFinder(meta=True, metagenomic_bins=sub)
    restricted = p1.find_genes(record.seq)
    assert restricted.metagenomic_bin.description == chosen.description
    assert [(g.begin, g.end) for g in restricted] == \
        [(g.begin, g.end) for g in full]


def test_meta_short_sequences():
    p = GeneFinder(meta=True)
    seq = "AATGTAGGAAAAACAGCATTTTCATTTCGCCATTTT"
    for i in range(1, len(seq)):
        genes = p.find_genes(seq[:i])
        assert len(genes) == 0


@needs_bins
def test_tpu_meta_runner_matches_c_path(data):
    """The fully on-device runner (device scoring + DP) must reproduce the
    sequential C meta path for every contig: winner bin, coordinates, and
    gene-data strings (interpret-mode Pallas on CPU)."""
    pytest.importorskip("jax")
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    seqs = [
        list(parse(data("KK037166.fna.gz")))[0].seq,
        list(parse(data("SRR492066.fna.gz")))[0].seq[:30000],
    ]
    p = GeneFinder(meta=True)
    anchor = [p.find_genes(s) for s in seqs]

    runner = TpuMetaRunner(METAGENOMIC_BINS, node_bucket=1536,
                           batch_size=8, interpret=True)
    batched = runner.find_genes_batch(seqs)
    for a, b in zip(anchor, batched):
        assert b.metagenomic_bin.description == a.metagenomic_bin.description
        assert len(a) == len(b)
        assert [(g.begin, g.end, g.strand) for g in b] == \
            [(g.begin, g.end, g.strand) for g in a]
        assert all(
            x._gene_data(1) == y._gene_data(1) for x, y in zip(a, b)
        )


@needs_bins
@pytest.mark.parametrize("closed,mask", [(True, False), (False, True)])
def test_tpu_meta_runner_closed_mask(data, closed, mask):
    """closed=True and mask=True must flow through the on-device scoring."""
    pytest.importorskip("jax")
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:30000]
    if mask:
        seq = seq[:12000] + "N" * 120 + seq[12000:]
    p = GeneFinder(meta=True, closed=closed, mask=mask)
    a = p.find_genes(seq)

    runner = TpuMetaRunner(METAGENOMIC_BINS, node_bucket=1536,
                           batch_size=8, closed=closed, mask=mask,
                           interpret=True)
    b = runner.find_genes_batch([seq])[0]
    assert b.metagenomic_bin.description == a.metagenomic_bin.description
    assert [(g.begin, g.end, g.strand) for g in b] == \
        [(g.begin, g.end, g.strand) for g in a]
    assert all(x._gene_data(1) == y._gene_data(1) for x, y in zip(a, b))


@needs_bins
def test_mega_route_matches_c_path(data):
    """Contigs exceeding the std buckets take the mega route (one shared
    geometry, bins as rows) and must reproduce the sequential C meta path
    exactly.  seq_bucket is shrunk to force the
    mega route on a 30 kb contig."""
    pytest.importorskip("jax")
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:30000]
    p = GeneFinder(meta=True, backend="refcore")
    a = p.find_genes(seq)

    runner = TpuMetaRunner(METAGENOMIC_BINS, seq_bucket=2048,
                           interpret=True)
    b = runner.find_genes_batch([seq])[0]
    assert b.metagenomic_bin.description == a.metagenomic_bin.description
    assert [(g.begin, g.end, g.strand) for g in b] == \
        [(g.begin, g.end, g.strand) for g in a]
    assert all(x._gene_data(1) == y._gene_data(1) for x, y in zip(a, b))


def test_single_device_matches_c_path(data):
    """Device-native single mode (one-bin fused scoring+DP, is_meta=False)
    must reproduce the exact C single path on the golden genome."""
    pytest.importorskip("jax")
    import warnings
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    rec = list(parse(data("SRR492066.fna.gz")))[0]
    p = GeneFinder(backend="refcore")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p.train(rec.seq)
    a = p.find_genes(rec.seq)

    class _Bin:
        description = "single"

        def __init__(self, ti):
            self.training_info = ti

    runner = TpuMetaRunner([_Bin(p.training_info)], is_meta=False,
                           node_bucket=6144, seq_bucket=81920,
                           batch_size=8, interpret=True)
    b = runner.find_genes_batch([rec.seq])[0]
    assert len(a) == len(b) == 76
    assert [(g.begin, g.end, g.strand) for g in b] == \
        [(g.begin, g.end, g.strand) for g in a]
    assert all(x._gene_data(1) == y._gene_data(1) for x, y in zip(a, b))
    assert b.metagenomic_bin is None and b.meta is False


@needs_bins
@pytest.mark.parametrize("kw", [
    dict(min_gene=60, min_edge_gene=30, max_overlap=30),
    dict(min_gene=120, max_overlap=40),
    dict(max_overlap=0),
])
def test_tpu_meta_runner_option_variants(data, kw):
    """min_gene / min_edge_gene / max_overlap variants must flow through
    the batched device path identically to the C engine (mirror of the
    C-path variants in test_gene_finder)."""
    pytest.importorskip("jax")
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:24000]
    p = GeneFinder(meta=True, backend="refcore", **kw)
    a = p.find_genes(seq)

    runner = TpuMetaRunner(METAGENOMIC_BINS, node_bucket=1536,
                           batch_size=8, interpret=True, **kw)
    b = runner.find_genes_batch([seq])[0]
    assert b.metagenomic_bin.description == a.metagenomic_bin.description
    assert [(g.begin, g.end, g.strand) for g in b] == \
        [(g.begin, g.end, g.strand) for g in a]
    assert all(x._gene_data(1) == y._gene_data(1) for x, y in zip(a, b))


@needs_bins
def test_bin_near_tie_exact_arbitration(data):
    """Two bins with IDENTICAL models produce exactly tied path scores;
    the device sweep's f32 scores cannot order them, so the exact C
    engine must arbitrate — and the reference's `>` sweep keeps the
    EARLIER bin on ties (lib.pyx:5363-5365)."""
    pytest.importorskip("jax")
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:20000]
    p0 = GeneFinder(meta=True, backend="refcore")
    full = p0.find_genes(seq)
    chosen = full.metagenomic_bin

    class _Clone:
        description = "clone-of-winner"

        def __init__(self, ti):
            self.training_info = ti

    bins = MetagenomicBins((chosen, _Clone(chosen.training_info)))
    runner = TpuMetaRunner(bins, node_bucket=1536, batch_size=8,
                           interpret=True)
    b = runner.find_genes_batch([seq])[0]
    # earlier bin must win the exact tie
    assert b.metagenomic_bin.description == chosen.description
    assert [(g.begin, g.end, g.strand) for g in b] == \
        [(g.begin, g.end, g.strand) for g in full]


@needs_bins
def test_runner_thread_reentrancy(data):
    """Concurrent find_genes_batch calls share the runner (thread pool +
    refcore entry points must be state-free) and must be deterministic."""
    pytest.importorskip("jax")
    import concurrent.futures
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    seqs = [list(parse(data("SRR492066.fna.gz")))[0].seq[:15000],
            list(parse(data("KK037166.fna.gz")))[0].seq]
    runner = TpuMetaRunner(METAGENOMIC_BINS, node_bucket=1536,
                           batch_size=8, interpret=True)
    ref = runner.find_genes_batch(seqs)
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(lambda _: runner.find_genes_batch(seqs),
                           range(4)))
    for out in outs:
        for a, b in zip(ref, out):
            assert [(g.begin, g.end, g.strand) for g in a] == \
                [(g.begin, g.end, g.strand) for g in b]
            assert all(x._gene_data(1) == y._gene_data(1)
                       for x, y in zip(a, b))


@needs_bins
@pytest.mark.parametrize("closed,mask", [(True, False), (False, True)])
def test_mega_route_closed_mask(data, closed, mask):
    """closed=True / mask=True must flow through the mega kernel route
    identically to the C engine."""
    pytest.importorskip("jax")
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:24000]
    if mask:
        seq = seq[:9000] + "N" * 120 + seq[9000:]
    p = GeneFinder(meta=True, closed=closed, mask=mask, backend="refcore")
    a = p.find_genes(seq)

    runner = TpuMetaRunner(METAGENOMIC_BINS, seq_bucket=2048,
                           closed=closed, mask=mask, interpret=True)
    b = runner.find_genes_batch([seq])[0]
    assert b.metagenomic_bin.description == a.metagenomic_bin.description
    assert [(g.begin, g.end, g.strand) for g in b] == \
        [(g.begin, g.end, g.strand) for g in a]
    assert all(x._gene_data(1) == y._gene_data(1) for x, y in zip(a, b))


@needs_bins
def test_many_tiny_contigs_batch(data):
    """A batch of many tiny/odd contigs (empty, all-N, short, normal)
    must keep launch packing, slot mapping and num_seq ordering straight."""
    pytest.importorskip("jax")
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    base = list(parse(data("SRR492066.fna.gz")))[0].seq
    seqs = []
    for k in range(40):
        if k % 7 == 0:
            seqs.append("")                        # empty
        elif k % 7 == 1:
            seqs.append("N" * 500)                 # all-N
        elif k % 7 == 2:
            seqs.append(base[:90])                 # sub-min-gene
        else:
            seqs.append(base[(k * 997) % 20000:][:4000])
    p = GeneFinder(meta=True, backend="refcore")
    anchor = [p.find_genes(s) for s in seqs]

    runner = TpuMetaRunner(METAGENOMIC_BINS, node_bucket=1536,
                           batch_size=32, interpret=True)
    outs = runner.find_genes_batch(seqs, num_seq_start=1)
    assert len(outs) == len(seqs)
    for i, (a, b) in enumerate(zip(anchor, outs)):
        assert len(a) == len(b), i
        assert [(g.begin, g.end, g.strand) for g in b] == \
            [(g.begin, g.end, g.strand) for g in a]
        assert b._num_seq == i + 1


@needs_bins
def test_mega_route_packed_multi_contig(data):
    """Several mega-route contigs pack into ONE launch (node + sequence
    axes end-to-end, bin-row union as rows, per-contig terminal
    reduction).  The packed sweep must select the same winning bin and
    genes for every contig as the sequential C meta path — including
    contigs of different GC (different candidate-bin sets) and open
    ends (edge nodes at both contig boundaries)."""
    pytest.importorskip("jax")
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    srr = list(parse(data("SRR492066.fna.gz")))[0].seq
    miij = list(parse(data("MIIJ01000039.fna.gz")))[0].seq
    contigs = [srr[:30000], miij[:24000], srr[30000:54000]]

    p = GeneFinder(meta=True, backend="refcore")
    seq_results = [p.find_genes(c) for c in contigs]

    runner = TpuMetaRunner(METAGENOMIC_BINS, seq_bucket=2048,
                           interpret=True)
    packed_results = runner.find_genes_batch(contigs)
    # the runner really packed them into one launch
    groups = runner._group_mega([
        {"ci": i, "g": runner._prepare_contig(
            __import__("pyrodigal_tpu").sequence.Sequence(c))[1][11],
         "rows": runner._candidate_bins(
             __import__("pyrodigal_tpu").sequence.Sequence(c))}
        for i, c in enumerate(contigs)])
    assert len(groups) < len(contigs)
    assert max(len(g["items"]) for g in groups) >= 2

    for a, b in zip(seq_results, packed_results):
        assert b.metagenomic_bin.description == \
            a.metagenomic_bin.description
        assert [(g.begin, g.end, g.strand) for g in b] == \
            [(g.begin, g.end, g.strand) for g in a]
        assert all(x._gene_data(1) == y._gene_data(1)
                   for x, y in zip(a, b))


@needs_bins
def test_mega_route_fxs_rescale(data):
    """Contigs past MEGA_FXS_LIMIT run the mega DP at half fixed-point
    scale (FXS=1024) to double the score range (the >13 Mbp ceiling);
    forcing that scale on a small contig must still reproduce the exact
    C path gene-for-gene."""
    pytest.importorskip("jax")
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:30000]
    p = GeneFinder(meta=True, backend="refcore")
    a = p.find_genes(seq)

    class _HalfFXS(TpuMetaRunner):
        MEGA_FXS_LIMIT = 1          # every mega contig takes FXS=1024

    runner = _HalfFXS(METAGENOMIC_BINS, seq_bucket=2048, interpret=True)
    b = runner.find_genes_batch([seq])[0]
    assert b.metagenomic_bin.description == a.metagenomic_bin.description
    assert [(g.begin, g.end, g.strand) for g in b] == \
        [(g.begin, g.end, g.strand) for g in a]
    assert all(x._gene_data(1) == y._gene_data(1) for x, y in zip(a, b))


@needs_bins
def test_star_pointers_match_refcore(data):
    """The device star sweep (score_device.star_pointers, run inside the
    scoring) must reproduce refcore's overlapping-start pointers
    (`record_overlapping_starts`, flag 1) for every candidate bin over the
    same nodes."""
    pytest.importorskip("jax")
    import numpy as np
    import jax.numpy as jnp
    from pyrodigal_tpu.sequence import Sequence
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner
    from pyrodigal_tpu.ops import score_device as sd

    seq = Sequence(list(parse(data("SRR492066.fna.gz")))[0].seq[:24576])
    runner = TpuMetaRunner(METAGENOMIC_BINS, interpret=True)
    cand, geoms, nodes_by_tt, _route = runner._prepare_contig(seq)
    tt = 11
    g = geoms[tt]
    rows = [b for b in cand
            if METAGENOMIC_BINS[b].training_info.translation_table == tt]
    nn = g["nn"]
    NT = 2048 * ((nn + 2047) // 2048)
    SB = ((seq.slen + 196607) // 196608) * 196608
    packed = sd.pack_geometries([g], 1, NT, SB)
    geo = {k: jnp.asarray(v) for k, v in packed.items()}
    bin_idx = np.zeros(16, np.int32)
    bin_idx[:len(rows)] = rows
    out = sd.score_only(runner.tables.as_tuple(), geo, jnp.asarray(bin_idx),
                        jnp.zeros(16, jnp.int32), is_meta=True, closed=False,
                        S3=SB // 3, has_nonsd=runner.tables.any_nonsd,
                        relk=runner.relk, max_overlap=60)
    star_ptr = np.asarray(out[10])                     # (3, BT, NT)
    for r, b in enumerate(rows):
        nodes = runner._score_winner(seq, nodes_by_tt, b)
        want = nodes.star_ptr[:nn * 3].reshape(nn, 3)
        assert np.array_equal(star_ptr[:, r, :nn].T, want), b


@needs_bins
def test_geo_compression_roundtrip(data):
    """compress_geo (the host-link byte-pack) + _unpack_geo must reproduce
    the geometry exactly: digits 2 bases/byte, six int8 flag rows in one
    byte/node (see score_device.compress_geo)."""
    import numpy as np
    import jax.numpy as jnp
    from pyrodigal_tpu.sequence import Sequence
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner
    from pyrodigal_tpu.ops import score_device as sd

    seq = Sequence(list(parse(data("SRR492066.fna.gz")))[0].seq)
    runner = TpuMetaRunner(METAGENOMIC_BINS, interpret=True)
    _cand, geoms, _nbt, _route = runner._prepare_contig(seq)
    g = geoms[list(geoms)[0]]
    NT = 2048 * ((g["nn"] + 2047) // 2048)
    SB = ((seq.slen + 196607) // 196608) * 196608
    packed = sd.pack_geometries([g], 1, NT, SB)
    comp = sd.compress_geo(packed)
    assert sum(v.nbytes for v in comp.values()) \
        < 0.7 * sum(v.nbytes for v in packed.values())
    geo = sd._unpack_geo({k: jnp.asarray(v) for k, v in comp.items()})
    assert np.array_equal(np.asarray(geo["digits"]), packed["digits"])
    assert np.array_equal(np.asarray(geo["n8"]), packed["n8"])
    for k in ("n32", "slen"):
        assert np.array_equal(np.asarray(geo[k]), packed[k])
    # plain dicts pass through untouched
    plain = {k: jnp.asarray(v) for k, v in packed.items()}
    assert sd._unpack_geo(plain) is plain
