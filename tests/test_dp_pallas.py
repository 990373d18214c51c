"""The Pallas DP kernel (interpret mode on the CPU, compiled on a GPU)
against the plain `dp_jax` scan and the exact float64 C engine, row by
row, plus the platform gate that decides how the kernels run."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from pyrodigal_tpu import GeneFinder, Nodes, Sequence  # noqa: E402
from pyrodigal_tpu import METAGENOMIC_BINS  # noqa: E402
from pyrodigal_tpu.fasta import parse  # noqa: E402
from pyrodigal_tpu.ops import dp_jax, dp_pallas, platform  # noqa: E402
from pyrodigal_tpu.ops import score_device as sd  # noqa: E402
from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner  # noqa: E402

needs_bins = pytest.mark.skipif(
    len(METAGENOMIC_BINS) == 0,
    reason="metagenomic bins asset not built (scripts/build_bins.py)",
)


def _srr(data):
    return list(parse(data("SRR492066.fna.gz")))[0].seq


def _check_rows(runner, best, rows, jb=None):
    """Each real row's device best path score within the runner's
    bin-arbitration margin of refcore's f64 score (and of dp_jax's)."""
    for r, (seq, nbt, b) in enumerate(rows):
        ref = chip_smoke.ref_best(runner, seq, nbt, b)
        assert abs(best[r] - ref) <= runner._margin(ref), (r, b, best[r], ref)
        if jb is not None:
            assert abs(best[r] - jb[r]) <= runner._margin(ref), (r, jb[r])


@needs_bins
def test_std_launch_rows_match_refcore_and_dp_jax(data):
    """A batched launch (a geometry per row, padded rows after the real
    ones, nodes padded to the bucket) against refcore and dp_jax."""
    srr = _srr(data)
    runner = TpuMetaRunner(METAGENOMIC_BINS, node_bucket=1024,
                           seq_bucket=12288, batch_size=48, interpret=True)
    work, geoms, rows = [], {}, []
    for ci, (lo, n) in enumerate(((0, 6000), (21000, 9000), (52000, 2500))):
        seq = Sequence(srr[lo:lo + n])
        cand, g, nbt, route = runner._prepare_contig(seq)
        assert route == "std"
        for b in cand:
            key = (ci, METAGENOMIC_BINS[b].training_info.translation_table)
            geoms.setdefault(key, g[key[1]])
            work.append((ci, b, key))
            rows.append((seq, nbt, b))
    assert len(work) < 48                      # padded rows present
    args, kwargs = runner._std_launch(work, geoms)
    *_, best = sd.score_dp_launch(*args, **kwargs)
    scored = sd.score_only(*args, **{k: kwargs[k] for k in (
        "is_meta", "closed", "S3", "has_nonsd", "relk", "max_overlap")})
    jb = np.asarray(chip_smoke.dp_jax_best(scored, kwargs["lookback"],
                                           shared=False))
    _check_rows(runner, np.asarray(best), rows, jb)


@needs_bins
def test_mega_packed_rows_match_refcore(data):
    """The mega layout: one shared geometry of three contigs packed end to
    end (node ranges padded to the tile, interior kind-4 pads), the
    bin-row union as rows, per-contig best scores through node_bounds."""
    srr = _srr(data)
    runner = TpuMetaRunner(METAGENOMIC_BINS, seq_bucket=2048,
                           interpret=True)
    items, preps = [], []
    for ci, s in enumerate((srr[:14000], srr[22000:34000],
                            srr[40000:52000])):
        seq = Sequence(s)
        cand, g, nbt, route = runner._prepare_contig(seq)
        assert route == "mega"
        tt = 11
        rows = [b for b in cand
                if METAGENOMIC_BINS[b].training_info.translation_table == tt]
        items.append({"ci": ci, "g": g[tt], "rows": rows})
        preps.append((seq, nbt))
    args, kwargs, brows, CP, B = runner._mega_launch(items)
    assert CP >= 3 and len(brows) <= B
    *_, best = sd.score_dp_mega(*args, **kwargs)
    best = np.asarray(best)                    # (CP, B)
    for k, it in enumerate(items):
        seq, nbt = preps[k]
        for b in it["rows"]:
            r = brows.index(b)
            ref = chip_smoke.ref_best(runner, seq, nbt, b)
            assert abs(best[k, r] - ref) <= runner._margin(ref), (k, b)


def _scored_nodes(seq_str, tinf):
    seq = Sequence(seq_str)
    nodes = Nodes()
    nodes.extract(seq, translation_table=11)
    nodes.sort()
    nodes.reset_scores()
    nodes.score_nodes(seq, tinf)
    nodes.record_overlapping_starts(tinf, 1, 60)
    return nodes


@pytest.fixture(scope="module")
def srr_nodes(data):
    import warnings

    srr = _srr(data)
    finder = GeneFinder(backend="refcore")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tinf = finder.train(srr)
    return _scored_nodes(srr[:12000], tinf), tinf


@pytest.mark.parametrize("lookback,stretch", [
    (1920, 0), (1920, 1900), (4096, 3000), (4096, 4096)])
def test_kernel_window_chunks_match_dp_jax(srr_nodes, lookback, stretch):
    """Windows stretched back by up to `stretch` nodes make the kernel walk
    1-4 window chunks of CW lanes, crossing chunk and front-pad
    boundaries; every node's score must agree with the dp_jax scan over
    the same windows."""
    nodes, tinf = srr_nodes
    n = nodes.length
    ndx = nodes.ndx[:n].astype(np.int32)
    sv = nodes.stop_val[:n].astype(np.int32)
    typ = nodes.type[:n].astype(np.int32)
    strand = nodes.strand[:n].astype(np.int32)
    win = dp_jax.window_starts(ndx.astype(np.int64), sv.astype(np.int64),
                               typ, strand)
    rng = np.random.default_rng(lookback + stretch)
    back = rng.integers(0, stretch + 1, size=n) if stretch else 0
    win = np.maximum(np.minimum(win, np.arange(n) - back), 0)
    win = np.maximum(win, np.arange(n) - lookback).astype(np.int32)
    cs = (nodes.cscore[:n] + nodes.sscore[:n]).astype(np.float32)
    rsc = nodes.rscore[:n].astype(np.float32)
    usc = nodes.uscore[:n].astype(np.float32)
    sp = nodes.star_ptr[:n * 3].reshape(n, 3).astype(np.int32)
    valid = np.ones(n, bool)
    stw = np.float32(tinf.start_weight)

    ref, _, _ = dp_jax.dp_scores(ndx, sv, typ, strand, cs, rsc, usc, sp,
                                 win, valid, stw, W=lookback)
    score, traceb, _, best = dp_pallas.dp_core(
        *(jnp.asarray(a)[None] for a in (ndx, sv, typ, strand, win, valid)),
        *(jnp.asarray(a)[None] for a in (cs, rsc, usc)),
        jnp.asarray(sp.T)[:, None], jnp.asarray([stw]),
        lookback=lookback, interpret=True)
    ref = np.asarray(ref)
    assert np.allclose(np.asarray(score)[0], ref, atol=0.05)
    term = ((strand == 1) & (typ == 3)) | ((strand == -1) & (typ != 3))
    assert abs(float(best[0]) - ref[term].max()) < 0.05
    assert int(np.asarray(traceb).max()) < n


def test_quant_is_round_half_even():
    """The kernel's fixed-point rounding equals `jnp.round` (ties to even),
    ties included."""
    k = np.arange(-4000, 4000)
    x = np.concatenate([(k + 0.5) / dp_pallas.FXS, k * 0.37 / dp_pallas.FXS,
                        np.linspace(-80, 80, 4001)]).astype(np.float32)
    got = np.asarray(dp_pallas._quant(jnp.asarray(x), dp_pallas.FXS))
    want = np.asarray(jnp.round(jnp.asarray(x) * dp_pallas.FXS)
                      ).astype(np.int32)
    assert np.array_equal(got, want)


# ---- the platform gate ---------------------------------------------------

class _Dev:
    def __init__(self, name):
        self.platform = name


@pytest.mark.parametrize("name,interpret", [("cpu", True), ("gpu", False)])
def test_platform_kernel_mode(monkeypatch, name, interpret):
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev(name)])
    assert platform.platform() == name
    assert platform.interpret_kernels() is interpret


def test_platform_other_raises(monkeypatch):
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev("rocm")])
    with pytest.raises(RuntimeError, match="GPU"):
        platform.interpret_kernels()


def test_detect_backend(monkeypatch):
    """detect: the device path on a GPU, the C engine on a CPU host."""
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev("gpu")])
    assert GeneFinder()._resolve_backend() == "jax"
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev("cpu")])
    assert GeneFinder()._resolve_backend() == "refcore"


def test_detect_backend_surfaces_startup_errors(monkeypatch):
    """A JAX/CUDA start-up failure is raised, not turned into refcore."""
    def broken(*_a):
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.setattr(jax, "devices", broken)
    with pytest.raises(RuntimeError, match="cuda"):
        GeneFinder(meta=True).find_genes("ATG" * 100)
    assert GeneFinder(backend="refcore")._resolve_backend() == "refcore"


def test_backend_names():
    with pytest.raises(ValueError, match='backend="jax"'):
        GeneFinder(backend="tpu")
    with pytest.raises(ValueError, match="unknown backend"):
        GeneFinder(backend="cuda")


def test_compile_cache_dir(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "e"))
        assert platform.use_compile_cache(str(tmp_path)) == \
            str(tmp_path / "e")
        assert jax.config.jax_compilation_cache_dir == before
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = platform.use_compile_cache(str(tmp_path))
        assert path == str(tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
