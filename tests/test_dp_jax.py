"""Differential tests: the JAX scan DP against the exact C engine.

Plays the role of the reference's backend-differential suite
(reference: tests/test_connection_scorer.py): the device path must produce
the same final gene set as the exact float64 engine.
"""

import ctypes
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pyrodigal_tpu import GeneFinder, Sequence, Nodes, _native  # noqa: E402
from pyrodigal_tpu.genes import Genes  # noqa: E402
from pyrodigal_tpu.fasta import parse  # noqa: E402
from pyrodigal_tpu.ops import dp_jax  # noqa: E402


def _scored_nodes(seq_str, tinf, tt=11):
    seq = Sequence(seq_str)
    nodes = Nodes()
    nodes.extract(seq, translation_table=tt)
    nodes.sort()
    nodes.reset_scores()
    nodes.score_nodes(seq, tinf)
    nodes.record_overlapping_starts(tinf, 1, 60)
    return seq, nodes


def _genes_from(nodes, ipath, tinf):
    nodes.eliminate_bad_genes(ipath, tinf)
    g = Genes()
    g._extract(nodes, ipath)
    g._tweak_final_starts(nodes, tinf, 60)
    return list(zip(g._begin.tolist(), g._end.tolist()))


def _run_jax_dp(nodes, tinf):
    n = nodes.length
    ndx = nodes.ndx[:n].astype(np.int32)
    sv = nodes.stop_val[:n].astype(np.int32)
    typ = nodes.type[:n].astype(np.int32)
    strand = nodes.strand[:n].astype(np.int32)
    win_lo = dp_jax.window_starts(ndx, sv, typ, strand)
    ext = int((np.arange(n) - win_lo).max()) if n else 1
    W = max(256, int(np.ceil(ext / 256) * 256))
    cs = (nodes.cscore[:n] + nodes.sscore[:n]).astype(np.float32)
    score, traceb, ov = dp_jax.dp_scores(
        jnp.asarray(ndx), jnp.asarray(sv), jnp.asarray(typ),
        jnp.asarray(strand), jnp.asarray(cs),
        jnp.asarray(nodes.rscore[:n].astype(np.float32)),
        jnp.asarray(nodes.uscore[:n].astype(np.float32)),
        jnp.asarray(nodes.star_ptr[:n * 3].reshape(n, 3).astype(np.int32)),
        jnp.asarray(win_lo), jnp.ones(n, bool),
        jnp.float32(tinf.start_weight), W=W,
    )
    nodes.score[:n] = np.asarray(score, dtype=np.float64)
    nodes.traceb[:n] = np.asarray(traceb)
    nodes.ov_mark[:n] = np.asarray(ov)
    s = nodes._struct()
    return _native.lib.rc_dp_finish(ctypes.byref(s))


def test_dp_jax_matches_c_single(data):
    record = list(parse(data("SRR492066.fna.gz")))[0]
    p = GeneFinder(meta=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tinf = p.train(record.seq)

    _, cn = _scored_nodes(record.seq, tinf)
    ipath_c = cn.dynamic_programming(tinf, final=True)
    genes_c = _genes_from(cn, ipath_c, tinf)

    _, jn = _scored_nodes(record.seq, tinf)
    ipath_j = _run_jax_dp(jn, tinf)
    genes_j = _genes_from(jn, ipath_j, tinf)

    assert len(genes_c) == 76
    assert genes_c == genes_j


def test_dp_jax_scores_close(data):
    record = list(parse(data("SRR492066.fna.gz")))[0]
    p = GeneFinder(meta=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tinf = p.train(record.seq)

    _, cn = _scored_nodes(record.seq, tinf)
    cn.dynamic_programming(tinf, final=True)

    _, jn = _scored_nodes(record.seq, tinf)
    _run_jax_dp(jn, tinf)

    n = cn.length
    rel = np.abs(jn.score[:n] - cn.score[:n]) / np.maximum(
        np.abs(cn.score[:n]), 1.0
    )
    assert rel.max() < 1e-5
    agree = (jn.traceb[:n] == cn.traceb[:n]).mean()
    assert agree > 0.97
