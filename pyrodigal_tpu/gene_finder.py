"""The `GeneFinder` orchestrator (reference: lib.pyx:5071-5575).

Runs the exact C reference engine (``backend="refcore"``) or the batched
JAX device pipeline (``backend="jax"``, `pyrodigal_tpu.ops`);
``backend="detect"`` picks the device pipeline when a GPU is present.
"""

import functools
import itertools
import threading
import warnings

from ._constants import (
    MIN_GENE, MIN_EDGE_GENE, MAX_SAM_OVLP, MASK_SIZE,
    MIN_SINGLE_GENOME, IDEAL_SINGLE_GENOME, WINDOW, TRANSLATION_TABLES,
)
from .sequence import Sequence
from .nodes import Nodes
from .genes import Genes
from .training import TrainingInfo
from . import _native

BACKENDS = ("detect", "refcore", "jax")


class GeneFinder:
    """A configurable gene finder for genomes and metagenomes.

    Example:
        >>> from pyrodigal_tpu import GeneFinder
        >>> finder = GeneFinder(meta=True, backend="refcore")
        >>> genes = finder.find_genes("TTAATTAATTAA" * 4)   # too short
        >>> len(genes)
        0
        >>> GeneFinder(min_gene=60, backend="refcore")
        pyrodigal_tpu.gene_finder.GeneFinder(min_gene=60)
    """

    def __init__(
        self,
        training_info=None,
        *,
        meta=False,
        metagenomic_bins=None,
        closed=False,
        mask=False,
        min_mask=MASK_SIZE,
        min_gene=MIN_GENE,
        min_edge_gene=MIN_EDGE_GENE,
        max_overlap=MAX_SAM_OVLP,
        backend="detect",
    ):
        if meta and training_info is not None:
            raise ValueError("cannot use a training info in meta mode.")
        if min_gene <= 0:
            raise ValueError("`min_gene` must be strictly positive")
        if min_edge_gene <= 0:
            raise ValueError("`min_edge_gene` must be strictly positive")
        if min_mask < 0:
            raise ValueError("`min_mask` must be positive")
        if max_overlap < 0:
            raise ValueError("`max_overlap` must be positive")
        elif max_overlap > min_gene:
            raise ValueError("`max_overlap` must be lower than `min_gene`")
        if backend not in BACKENDS:
            hint = ' (use backend="jax")' if backend == "tpu" else ""
            raise ValueError(
                f"unknown backend {backend!r}{hint}; expected one of "
                f"{', '.join(map(repr, BACKENDS))}")

        self.meta = meta
        self.closed = closed
        self.lock = threading.Lock()
        self.mask = mask
        self.training_info = training_info
        self.min_mask = min_mask
        self.min_gene = min_gene
        self.min_edge_gene = min_edge_gene
        self.max_overlap = max_overlap
        self.backend = backend
        self._num_seq = 1
        self._meta_runner = None
        self._single_runner = None
        self._single_runner_tinf = None
        if metagenomic_bins is None:
            from .metagenomic import METAGENOMIC_BINS
            self.metagenomic_bins = METAGENOMIC_BINS
        else:
            self.metagenomic_bins = metagenomic_bins

    def _resolve_backend(self):
        """Resolve ``backend="detect"`` against the available hardware:
        a GPU selects the batched JAX/Pallas pipeline, a CPU-only host (or
        one without jax installed) keeps the exact C engine (reference
        dispatch analog: lib.pyx:1359-1432).  A JAX or CUDA start-up
        failure is raised, not hidden behind the C engine."""
        if self.backend != "detect":
            return self.backend
        try:
            from .ops.platform import platform
        except ImportError:
            return "refcore"
        return "jax" if platform() == "gpu" else "refcore"

    def _get_meta_runner(self):
        with self.lock:
            if self._meta_runner is None:
                from .ops.meta_tpu import TpuMetaRunner

                self._meta_runner = TpuMetaRunner(
                    self.metagenomic_bins,
                    closed=self.closed,
                    mask=self.mask,
                    min_mask=self.min_mask,
                    min_gene=self.min_gene,
                    min_edge_gene=self.min_edge_gene,
                    max_overlap=self.max_overlap,
                )
            return self._meta_runner

    def _get_single_runner(self):
        """Device-native single mode: the fused scoring+DP pipeline with
        ONE bin (the trained `TrainingInfo`), is_meta=False — the single
        and meta call stacks share the accelerator path, like the
        reference's always-on backend dispatch (lib.pyx:1359-1432)."""
        with self.lock:
            tinf = self.training_info
            if self._single_runner is None \
                    or self._single_runner_tinf is not tinf:
                from .ops.meta_tpu import TpuMetaRunner

                class _SingleBin:
                    description = "single"

                    def __init__(self, ti):
                        self.training_info = ti

                self._single_runner = TpuMetaRunner(
                    [_SingleBin(tinf)],
                    is_meta=False,
                    closed=self.closed,
                    mask=self.mask,
                    min_mask=self.min_mask,
                    min_gene=self.min_gene,
                    min_edge_gene=self.min_edge_gene,
                    max_overlap=self.max_overlap,
                )
                self._single_runner_tinf = tinf
            return self._single_runner

    def __repr__(self):
        template = []
        if self.training_info is not None:
            template.append(f"training_info={self.training_info!r}")
        if self.meta:
            template.append(f"meta={self.meta!r}")
        if self.closed:
            template.append(f"closed={self.closed!r}")
        if self.mask:
            template.append(f"mask={self.mask!r}")
        if self.min_gene != MIN_GENE:
            template.append(f"min_gene={self.min_gene!r}")
        if self.min_edge_gene != MIN_EDGE_GENE:
            template.append(f"min_edge_gene={self.min_edge_gene!r}")
        if self.max_overlap != MAX_SAM_OVLP:
            template.append(f"max_overlap={self.max_overlap!r}")
        ty = type(self)
        return "{}.{}({})".format(ty.__module__, ty.__name__, ", ".join(template))

    def __reduce__(self):
        fn = functools.partial(
            type(self),
            meta=self.meta,
            metagenomic_bins=self.metagenomic_bins,
            closed=self.closed,
            mask=self.mask,
            min_mask=self.min_mask,
            min_gene=self.min_gene,
            min_edge_gene=self.min_edge_gene,
            max_overlap=self.max_overlap,
            backend=self.backend,
        )
        return fn, (self.training_info,)

    # --- internals ------------------------------------------------------------

    def _extract_sorted(self, nodes, seq, tt):
        nodes.extract(
            seq, translation_table=tt, closed=self.closed,
            min_gene=self.min_gene, min_edge_gene=self.min_edge_gene,
        )
        nodes.sort()

    def _train(self, seq, nodes, tinf, force_nonsd):
        """(reference: lib.pyx:5236-5279)"""
        self._extract_sorted(nodes, seq, tinf.translation_table)
        gc_plot = seq.max_gc_frame_plot(WINDOW)
        nodes.record_gc_bias(gc_plot, seq.slen, tinf)
        nodes.record_overlapping_starts(tinf, 0, self.max_overlap)
        ipath = nodes.dynamic_programming(tinf, final=False)
        import ctypes
        s = nodes._struct()
        _native.lib.rc_calc_dicodon_gene(
            _native.u8(tinf.raw), _native.u8(seq.digits), seq.slen,
            ctypes.byref(s), int(ipath),
        )
        _native.lib.rc_raw_coding_score(
            _native.u8(seq.digits), seq.slen, ctypes.byref(s),
            _native.u8(tinf.raw),
        )
        _native.lib.rc_rbs_score(
            _native.u8(seq.digits), seq.slen, ctypes.byref(s),
            _native.u8(tinf.raw),
        )
        _native.lib.rc_train_starts_sd(
            _native.u8(seq.digits), seq.slen, ctypes.byref(s),
            _native.u8(tinf.raw),
        )
        if force_nonsd:
            tinf.uses_sd = False
        else:
            _native.lib.rc_determine_sd_usage(_native.u8(tinf.raw))
        if not tinf.uses_sd:
            _native.lib.rc_train_starts_nonsd(
                _native.u8(seq.digits), seq.slen, ctypes.byref(s),
                _native.u8(tinf.raw),
            )
        return tinf

    def _find_genes_single(self, seq, tinf, nodes, genes):
        """(reference: lib.pyx:5281-5315).  Runs on the exact C engine:
        a jax-capable host routes single mode through the fused device
        pipeline in `find_genes` before reaching here."""
        self._extract_sorted(nodes, seq, tinf.translation_table)
        nodes.reset_scores()
        nodes.score_nodes(seq, tinf, closed=self.closed, is_meta=False)
        nodes.record_overlapping_starts(tinf, 1, self.max_overlap)
        ipath = nodes.dynamic_programming(tinf, final=True)
        if nodes.length > 0:
            nodes.eliminate_bad_genes(ipath, tinf)
        genes._extract(nodes, ipath)
        genes._tweak_final_starts(nodes, tinf, self.max_overlap)

    def _find_genes_meta(self, seq, nodes, genes):
        """(reference: lib.pyx:5317-5396)"""
        low = min(0.65, 0.88495 * seq.gc - 0.0102337)
        high = max(0.35, 0.86596 * seq.gc + 0.1131991)

        tt = -1
        max_phase = -1
        max_score = -100.0

        for i in range(len(self.metagenomic_bins)):
            bin_ = self.metagenomic_bins[i]
            tinf = bin_.training_info
            if tinf.gc < low or tinf.gc > high:
                continue
            if tinf.translation_table != tt:
                tt = tinf.translation_table
                nodes.clear()
                self._extract_sorted(nodes, seq, tt)
            nodes.reset_scores()
            nodes.score_nodes(seq, tinf, closed=self.closed, is_meta=True)
            nodes.record_overlapping_starts(tinf, 1, self.max_overlap)
            ipath = nodes.dynamic_programming(tinf, final=True)
            if nodes.length > 0 and ipath >= 0 and nodes.score[ipath] > max_score:
                max_phase = i
                max_score = nodes.score[ipath]
                nodes.eliminate_bad_genes(ipath, tinf)
                genes._clear()
                genes._extract(nodes, ipath)
                genes._tweak_final_starts(nodes, tinf, self.max_overlap)

        if max_phase >= 0:
            tinf = self.metagenomic_bins[max_phase].training_info
            nodes.clear()
            self._extract_sorted(nodes, seq, tinf.translation_table)
            nodes.reset_scores()
            nodes.score_nodes(seq, tinf, closed=self.closed, is_meta=True)
        return max_phase

    # --- public API -----------------------------------------------------------

    def find_genes(self, sequence):
        """Find all the genes in the input DNA sequence."""
        if not self.meta and self.training_info is None:
            raise RuntimeError(
                "cannot find genes without having trained in single mode"
            )
        if self._resolve_backend() == "jax" and (
                (self.meta and len(self.metagenomic_bins) > 0)
                or not self.meta):
            with self.lock:
                num_seq = self._num_seq
                self._num_seq += 1
            runner = self._get_meta_runner() if self.meta \
                else self._get_single_runner()
            return runner.find_genes_batch([sequence],
                                           num_seq_start=num_seq)[0]
        seq = Sequence(sequence, mask=self.mask, mask_size=self.min_mask)
        nodes = Nodes()
        genes = Genes()

        with self.lock:
            genes._num_seq = self._num_seq
            self._num_seq += 1

        if self.meta:
            phase = self._find_genes_meta(seq, nodes, genes)
            if phase >= 0:
                genes.metagenomic_bin = self.metagenomic_bins[phase]
                tinf = self.metagenomic_bins[phase].training_info
            else:
                genes.metagenomic_bin = tinf = None
        else:
            tinf = self.training_info
            self._find_genes_single(seq, tinf, nodes, genes)

        genes.sequence = seq
        genes.nodes = nodes
        genes.training_info = tinf
        genes.meta = self.meta
        return genes

    def find_genes_batch(self, sequences):
        """Find genes in a batch of input sequences.

        In meta mode on an accelerator backend this sweeps all
        (contig, bin) work items through the batched on-device
        scoring + DP pipeline; otherwise it maps `find_genes`.
        """
        sequences = list(sequences)
        if not self.meta and self.training_info is None:
            raise RuntimeError(
                "cannot find genes without having trained in single mode"
            )
        if self._resolve_backend() == "jax" and (
                (self.meta and len(self.metagenomic_bins) > 0)
                or not self.meta):
            with self.lock:
                num_seq = self._num_seq
                self._num_seq += len(sequences)
            runner = self._get_meta_runner() if self.meta \
                else self._get_single_runner()
            return runner.find_genes_batch(sequences,
                                           num_seq_start=num_seq)
        return [self.find_genes(s) for s in sequences]

    def train(self, sequence, *sequences, force_nonsd=False,
              start_weight=4.35, translation_table=11):
        """Search training parameters using one or more training sequences."""
        if self.meta:
            raise RuntimeError("cannot use training sequence in metagenomic mode")
        if translation_table not in TRANSLATION_TABLES:
            raise ValueError(
                f"{translation_table} is not a valid translation table index"
            )

        if isinstance(sequence, Sequence):
            if sequences:
                raise NotImplementedError(
                    "cannot use more than one `Sequence` object in "
                    "`GeneFinder.train`"
                )
            seq = Sequence(sequence, mask=self.mask, mask_size=self.min_mask)
        elif isinstance(sequence, str):
            if sequences:
                sequence = "TTAATTAATTAA".join(
                    itertools.chain([sequence], sequences, [""])
                )
            seq = Sequence(sequence, mask=self.mask, mask_size=self.min_mask)
        else:
            if sequences:
                sequence = b"TTAATTAATTAA".join(
                    itertools.chain([bytes(sequence)], map(bytes, sequences), [b""])
                )
            seq = Sequence(sequence, mask=self.mask, mask_size=self.min_mask)

        if seq.slen < MIN_SINGLE_GENOME:
            raise ValueError(
                f"sequence must be at least {MIN_SINGLE_GENOME} characters "
                f"({seq.slen} found)"
            )
        elif seq.slen < IDEAL_SINGLE_GENOME:
            warnings.warn(
                f"sequence should be at least {IDEAL_SINGLE_GENOME} characters "
                f"({seq.slen} found)"
            )

        nodes = Nodes()
        tinf = TrainingInfo(
            seq.gc, start_weight=start_weight,
            translation_table=translation_table,
        )
        self._train(seq, nodes, tinf, force_nonsd)

        with self.lock:
            self.training_info = tinf
        return tinf
