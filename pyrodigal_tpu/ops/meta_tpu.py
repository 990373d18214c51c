"""Fully device-resident meta mode: scoring + DP fused in one dispatch.

The whole per-bin pipeline — node scoring, star pointers, connection DP —
runs on the accelerator (`score_device` + the Pallas kernel), so the host
cost per contig is node extraction plus the bin-independent index
precompute, and the exact C engine re-scores only the winning bin for
output fidelity (reference: lib.pyx:5317-5396 for the sequential bin
sweep this replaces).

Launch pipeline: work items are packed so a contig's bins never split
across launches, every launch selects each contig's winning bin ON DEVICE
(`score_device.pack_winners`) and returns one packed tensor, and the host
pulls launches in order while the device runs later launches — winner
rescore + finishing (exact C) overlaps device compute on a thread pool.
"""

import collections
import concurrent.futures

import numpy as np
import jax.numpy as jnp

from ..sequence import Sequence
from ..nodes import Nodes
from ..genes import Genes
from . import dp_pallas
from . import score_device as sd
from .platform import interpret_kernels


class TpuMetaRunner:
    """Batched meta-mode gene calling with on-device per-bin scoring."""

    def __init__(self, metagenomic_bins, *, closed=False, min_gene=90,
                 min_edge_gene=60, max_overlap=60, mask=False, min_mask=50,
                 node_bucket=3072, seq_bucket=49152, batch_size=128,
                 block_size=16, max_geoms=16, relk=32, window=640,
                 prep_threads=8, interpret=None, mesh=None, is_meta=True):
        if interpret is None:
            interpret = interpret_kernels()
        self.bins = metagenomic_bins
        self.is_meta = is_meta
        self.mesh = mesh
        self.closed = closed
        self.min_gene = min_gene
        self.min_edge_gene = min_edge_gene
        self.max_overlap = max_overlap
        self.mask = mask
        self.min_mask = min_mask
        self.node_bucket = node_bucket
        self.seq_bucket = (seq_bucket + 383) // 384 * 384
        self.batch_size = (batch_size + block_size - 1) // block_size \
            * block_size
        self.block_size = block_size
        self.max_geoms = max_geoms
        self.relk = relk
        self.window = window
        self.interpret = interpret
        self.tables = sd.BinTables(metagenomic_bins)
        self.pool = concurrent.futures.ThreadPoolExecutor(prep_threads)
        # contigs per route ("std", "mega", "c" = host C fallback) over
        # the runner's lifetime
        self.route_counts = collections.Counter()

    # -- host side -----------------------------------------------------------

    def _candidate_bins(self, seq):
        if not self.is_meta:
            return [0] if len(self.bins) else []
        low = min(0.65, 0.88495 * seq.gc - 0.0102337)
        high = max(0.35, 0.86596 * seq.gc + 0.1131991)
        return [
            i for i in range(len(self.bins))
            if low <= self.bins[i].training_info.gc <= high
        ]

    # std-route DP lookback: the window extension i - win_lo[i] a batched
    # launch accepts (larger extensions take the mega route)
    STD_CHUNKS = 3
    # mega-route DP lookback (larger extensions take the exact C engine)
    MEGA_LOOKBACK = 4096
    # node tile of the mega geometry: packed contigs pad their node range
    # to it, and the scoring's tiled window gathers walk it
    MEGA_TILE = 2048
    # mega-route static buckets: node count (multiples of MEGA_TILE)
    # and sequence length (multiples of 196608 = lcm(384, 65536)); finer
    # steps cost one cached compile each but trim padded-node compute.
    # Up to ~8.65 Mbp the DP runs at FXS=2048 fixed point (absolute path
    # scores < 2^31/2048 = 1.05e6); larger contigs — through 17.3 Mbp,
    # beyond the largest known bacterial genomes — halve the scale to
    # FXS=1024 (score range 2.1e6, quantization still ~1e-3, well inside
    # the winner-arbitration margin).  Only contigs beyond that take the
    # exact C engine.
    MEGA_NT = (16384, 32768, 65536, 98304, 131072, 163840, 196608,
               262144, 327680, 393216, 458752, 589824, 786432, 1048576)
    MEGA_SB = (393216, 786432, 1179648, 1572864, 1966080, 2359296,
               2555904, 3145728, 4718592, 6291456, 7864320, 8650752,
               10616832, 13172736, 17301504)
    MEGA_FXS_LIMIT = 8650752        # FXS=2048 below, 1024 above
    MEGA_SW = 131072        # per-node-tile sequence span bound
    # packed-launch buckets: bin-row union per launch and contig count.
    # The 24-row cap was sized for an earlier kernel's on-chip scratch;
    # the row-per-program kernel has no such limit (ROADMAP R5).
    MEGA_ROWB = (8, 16, 24)
    # per-launch packing caps: big enough to amortize a dispatch, small
    # enough that launches, pulls and exact-C winner finishing pipeline
    # against each other (a single over-cap contig still gets its own
    # launch, bounded by MEGA_NT/MEGA_SB)
    MEGA_PACK_NB = 196608
    MEGA_PACK_SB = 4718592
    MEGA_CP = (1, 2, 4, 8, 12, 16)

    @staticmethod
    def _tile_span(ndx, nn, T=MEGA_TILE):
        if nn == 0:
            return 0
        starts = np.arange(0, nn, T)
        hi = np.minimum(starts + (T - 1), nn - 1)
        return int((ndx[hi] - ndx[starts]).max())

    def _compactify(self, g):
        """Gap-compacted window source: keep [ndx-56, ndx+56] around every
        node (merged), drop node-free stretches.  Window reads span at
        most +-54 bp of a node, so the compact digits reproduce every
        window byte; adds c_ndx / cdigits / c_slen to the geometry."""
        slen = g["slen"]
        ndx = g["ndx"].astype(np.int64)          # sorted (compare_nodes)
        M = 56
        diff = np.zeros(slen + 1, np.int32)
        np.add.at(diff, np.maximum(ndx - M, 0), 1)
        np.add.at(diff, np.minimum(ndx + M + 1, slen), -1)
        mask = np.cumsum(diff[:-1]) > 0
        cs = np.cumsum(mask)
        cdig = np.ascontiguousarray(g["digits"][mask])
        c_ndx = (cs[ndx] - 1).astype(np.int32)
        return dict(g, c_ndx=c_ndx, cdigits=cdig, c_len=int(cs[-1]))

    # route bounds kept from an earlier kernel that windowed rev-start
    # sources and ringed fwd-stop sources; the row-per-program kernel
    # scans the whole window and needs neither (ROADMAP R5)
    MEGA_DENSITY = 250      # max nodes in any 200 bp
    MEGA_RING = 256         # max fwd stops in any fwd start's window

    def _mega_ok(self, g):
        """Geometry constraints of the mega route.  May add the
        gap-compacted window source to `g` in place."""
        nn = g["nn"]
        if nn == 0 or nn > self.MEGA_NT[-1] or g["star_overflow"]:
            return False
        if g["slen"] > self.MEGA_SB[-1]:
            return False
        ext = int((np.arange(nn) - g["win_lo"]).max())
        if ext > self.MEGA_LOOKBACK:
            return False
        ndx_sorted = np.sort(g["ndx"][:nn])
        if nn and int((np.searchsorted(ndx_sorted, ndx_sorted + 200)
                       - np.arange(nn)).max()) > self.MEGA_DENSITY:
            return False
        from .._constants import STOP as _STOP
        fstop = ((g["typ"][:nn] == _STOP)
                 & (g["strand"][:nn] == 1)).astype(np.int64)
        cumf = np.concatenate([[0], np.cumsum(fstop)])
        idx = np.arange(nn)
        fstart = (g["typ"][:nn] != _STOP) & (g["strand"][:nn] == 1)
        in_win = np.where(fstart, cumf[idx] - cumf[g["win_lo"][:nn]], 0)
        if nn and int(in_win.max()) > self.MEGA_RING:
            return False
        # consecutive-node-tile sequence span (window gather locality);
        # gap compaction collapses node-free stretches when it overflows
        if self._tile_span(g["ndx"], nn) + 512 > self.MEGA_SW:
            gc = self._compactify(g)
            if self._tile_span(np.sort(gc["c_ndx"][:nn]), nn) + 512 \
                    > self.MEGA_SW:
                return False
            g.update(gc)
        return True

    def _prepare_contig(self, seq):
        """Returns (bin_ids, geoms, nodes_by_tt, route) with route one of
        "std" (bucketed batch path), "mega" (node-axis-gridded path for
        Mbp-scale contigs), "c" (host C fallback)."""
        cand = self._candidate_bins(seq)
        geoms, nodes_by_tt = {}, {}
        budget = self.STD_CHUNKS * self.window
        route = "std" if seq.slen <= self.seq_bucket else "mega"
        for b in cand:
            tt = self.bins[b].training_info.translation_table
            if route == "c" or tt in geoms:
                continue
            nodes = Nodes()
            nodes.extract(
                seq, translation_table=tt, closed=self.closed,
                min_gene=self.min_gene, min_edge_gene=self.min_edge_gene,
            )
            nodes.sort()
            nodes_by_tt[tt] = nodes
            g = sd.prepare_geometry(seq, nodes, tt, self.closed,
                                    self.max_overlap, self.relk)
            nn = g["nn"]
            if route == "std" and (
                    nn > self.node_bucket or g["star_overflow"]
                    or (nn and int((np.arange(nn) - g["win_lo"]).max())
                        > budget)):
                route = "mega"
            geoms[tt] = g
        if route == "mega":
            # validate EVERY geometry against the mega constraints (the
            # route may have been upgraded after earlier tts were seen)
            for g in geoms.values():
                if not self._mega_ok(g):
                    route = "c"
                    break
        return cand, geoms, nodes_by_tt, route

    # -- device side -----------------------------------------------------------

    def _std_launch(self, work, geoms):
        """Operands of one batched launch: (args, kwargs) for
        `score_device.score_dp_launch*`.  work: list of (ci, bin_id,
        geom_key); geoms: {key: geometry}."""
        # a single contig's bin list may exceed a small configured batch
        # size (tests); widen this launch to the next block multiple
        BT = max(self.batch_size,
                 (len(work) + self.block_size - 1)
                 // self.block_size * self.block_size)
        G = self.max_geoms
        n = self.node_bucket
        S = self.seq_bucket
        keys = list(geoms.keys())
        gmap = {k: i for i, k in enumerate(keys)}
        packed = sd.pack_geometries([geoms[k] for k in keys], G, n, S)
        bin_idx = np.zeros(BT, np.int32)
        gidx = np.zeros(BT, np.int32)
        for k, (ci, b, gkey) in enumerate(work):
            bin_idx[k] = b
            gidx[k] = gmap[gkey]
        geo = {k: jnp.asarray(v)
               for k, v in sd.compress_geo(packed).items()}
        # the non-SD motif machinery compiles in only when some bin of
        # THIS launch needs it (two cached variants at most)
        nonsd = bool((self.tables.uses_sd_np[
            [b for _ci, b, _g in work]] == 0).any())
        kwargs = dict(
            is_meta=self.is_meta, closed=self.closed, S3=S // 3,
            has_nonsd=nonsd, relk=self.relk,
            max_overlap=self.max_overlap,
            lookback=self.STD_CHUNKS * self.window,
            interpret=self.interpret)
        args = (self.tables.as_tuple(), geo, jnp.asarray(bin_idx),
                jnp.asarray(gidx))
        return args, kwargs

    def _sweep(self, work, geoms):
        """Dispatch one batched launch; returns the device handle of the
        packed winner tensor (one pull per launch)."""
        args, kwargs = self._std_launch(work, geoms)
        if self.mesh is not None:
            from ..parallel.meta_shard import sharded_score_dp_launch_packed

            return sharded_score_dp_launch_packed(self.mesh, *args, **kwargs)
        return sd.score_dp_launch_packed(*args, **kwargs)

    def _sweep_mega(self, g, bin_rows):
        """One mega launch: one Mbp-scale geometry, <= 16 bins as rows.
        Returns (device handle, NT bucket).  Kept for single geometries
        that ship a gap-compacted window source (see _compactify) — all
        other mega work goes through the packed `_sweep_mega_multi`."""
        NT = next(b for b in self.MEGA_NT if b >= g["nn"])
        SB = next(b for b in self.MEGA_SB if b >= g["slen"])
        BT = 16
        packed = sd.pack_geometries([g], 1, NT, SB)
        bin_idx = np.zeros(BT, np.int32)
        bin_idx[:len(bin_rows)] = bin_rows
        if "cdigits" in g:
            # gap-compacted window source (see _compactify)
            SCB = next(b for b in self.MEGA_SB if b >= g["c_len"])
            cd = np.zeros((1, SCB), np.uint8)
            cd[0, :g["c_len"]] = g["cdigits"]
            cn = np.zeros((1, NT), np.int32)
            cn[0, :g["nn"]] = g["c_ndx"]
            packed["cdigits"] = cd
            packed["c_ndx"] = cn
            packed["c_slen"] = np.array([g["c_len"]], np.int32)
        geo = {k: jnp.asarray(v)
               for k, v in sd.compress_geo(packed).items()}
        nonsd = bool((self.tables.uses_sd_np[list(bin_rows)] == 0).any())
        fxs = dp_pallas.FXS if g["slen"] <= self.MEGA_FXS_LIMIT \
            else dp_pallas.FXS // 2
        dev = sd.score_dp_launch_mega(
            self.tables.as_tuple(), geo, jnp.asarray(bin_idx),
            jnp.asarray(np.zeros(BT, np.int32)),
            is_meta=self.is_meta, closed=self.closed, S3=SB // 3,
            has_nonsd=nonsd, relk=self.relk,
            max_overlap=self.max_overlap, lookback=self.MEGA_LOOKBACK,
            fxs=fxs, interpret=self.interpret)
        return dev, NT

    @classmethod
    def _mega_regions(cls, g):
        T = cls.MEGA_TILE
        return (-(-g["nn"] // T) * T,
                (g["slen"] + 383) // 384 * 384 + 384)

    def _mega_fits(self, gr, it, nreg, sreg):
        return (len(gr["rows"] | set(it["rows"])) <= self.MEGA_ROWB[-1]
                and gr["nb"] + nreg <= self.MEGA_PACK_NB
                and gr["sb"] + sreg <= self.MEGA_PACK_SB
                and len(gr["items"]) < self.MEGA_CP[-1])

    # dispatch an open group as soon as it holds this many nodes: waiting
    # for the caps to fill exactly would stall the device behind host
    # prep at the head of a batch (pipelining beats maximal packing)
    MEGA_PACK_EAGER = 131072

    def _mega_add(self, open_groups, it):
        """Streaming packer: place a mega work item into an open group
        (first fit), or open a new one; returns any group that became
        unreachable (or eagerly full) and should be dispatched now.
        Groups are bounded by the row-union bucket, the per-launch
        packing caps and the contig-count bucket."""
        nreg, sreg = self._mega_regions(it["g"])
        placed = None
        for gr in open_groups:
            if self._mega_fits(gr, it, nreg, sreg):
                gr["items"].append(it)
                gr["rows"] |= set(it["rows"])
                gr["nb"] += nreg
                gr["sb"] += sreg
                placed = gr
                break
        if placed is None:
            placed = {"items": [it], "rows": set(it["rows"]),
                      "nb": nreg, "sb": sreg}
            open_groups.append(placed)
        if placed["nb"] >= self.MEGA_PACK_EAGER:
            open_groups.remove(placed)
            return placed
        # cap the number of concurrently-open groups: dispatch the
        # oldest once a third distinct signature shows up
        if len(open_groups) > 2:
            return open_groups.pop(0)
        return None

    def _group_mega(self, items):
        """Batch variant of the streaming packer (used by tests and the
        non-streaming callers): returns the launch groups in order."""
        open_groups, out = [], []
        for it in items:
            full = self._mega_add(open_groups, it)
            if full is not None:
                out.append(full)
        return out + open_groups

    def _mega_launch(self, items):
        """Operands of one PACKED mega launch — several contig geometries
        end-to-end on the node + sequence axes, the bin-row union as rows:
        (args, kwargs, rows, CP, B) for `score_device.score_dp_launch_mega`
        and the (CP, B) best-score demux."""
        T = self.MEGA_TILE
        nb = sum(-(-it["g"]["nn"] // T) * T for it in items)
        sb = sum((it["g"]["slen"] + 383) // 384 * 384 + 384
                 for it in items)
        NT = next(b for b in self.MEGA_NT if b >= nb)
        SB = next(b for b in self.MEGA_SB if b >= sb)
        CP = next(c for c in self.MEGA_CP if c >= len(items))
        rows = sorted({b for it in items for b in it["rows"]})
        B = next(b for b in self.MEGA_ROWB if b >= len(rows))
        if self.mesh is not None:
            D = self.mesh.devices.size
            B = -(-B // D) * D          # row shards must split evenly
        packed = sd.pack_geometries_multi([it["g"] for it in items],
                                          NT, SB, CP, T)
        bin_idx = np.full(B, rows[0], np.int32)
        bin_idx[:len(rows)] = rows
        geo = {k: jnp.asarray(v)
               for k, v in sd.compress_geo(packed).items()}
        nonsd = bool((self.tables.uses_sd_np[rows] == 0).any())
        fxs = dp_pallas.FXS \
            if max(it["g"]["slen"] for it in items) <= self.MEGA_FXS_LIMIT \
            else dp_pallas.FXS // 2
        kwargs = dict(
            is_meta=self.is_meta, closed=self.closed, S3=SB // 3,
            has_nonsd=nonsd, relk=self.relk,
            max_overlap=self.max_overlap, lookback=self.MEGA_LOOKBACK,
            fxs=fxs, interpret=self.interpret)
        args = (self.tables.as_tuple(), geo, jnp.asarray(bin_idx),
                jnp.asarray(np.zeros(B, np.int32)))
        return args, kwargs, rows, CP, B

    def _sweep_mega_multi(self, items):
        """Dispatch one packed mega launch; returns (device handle, rows,
        CP, B)."""
        args, kwargs, rows, CP, B = self._mega_launch(items)
        if self.mesh is not None:
            from ..parallel.meta_shard import sharded_score_dp_launch_mega

            dev = sharded_score_dp_launch_mega(self.mesh, *args, **kwargs)
        else:
            dev = sd.score_dp_launch_mega(*args, **kwargs)
        return dev, rows, CP, B

    # -- finishing (host, exact C on the winning bin) -------------------------

    def _finish(self, genes, seq, bin_id, nodes, ipath, out_nodes):
        tinf = self.bins[bin_id].training_info
        if nodes.length > 0:
            nodes.eliminate_bad_genes(ipath, tinf)
        genes._extract(nodes, ipath)
        genes._tweak_final_starts(nodes, tinf, self.max_overlap)
        # meta: the reference re-extracts + rescores the nodes for the
        # winning bin after the sweep, so the written per-gene scores are
        # the fresh model scores WITHOUT the eliminate/tweak adjustments
        # (lib.pyx:5380-5394) — `out_nodes` is the pre-DP scored snapshot,
        # identical to that rescore.  Single mode keeps the adjusted nodes
        # (lib.pyx:5281-5315).
        genes.nodes = out_nodes if self.is_meta else nodes
        genes.metagenomic_bin = self.bins[bin_id] if self.is_meta \
            else None
        genes.training_info = tinf
        return genes

    def _score_winner(self, seq, nodes_by_tt, bin_id):
        tinf = self.bins[bin_id].training_info
        nodes = nodes_by_tt[tinf.translation_table].copy()
        nodes.reset_scores()
        # NOTE: runs concurrently on the prep pool — the refcore scoring /
        # finishing entry points are state-free (see refcore.c header)
        nodes.score_nodes(seq, tinf, closed=self.closed,
                          is_meta=self.is_meta)
        nodes.record_overlapping_starts(tinf, 1, self.max_overlap)
        return nodes

    # -- driver ----------------------------------------------------------------

    def _produce_fallback(self, seq, num_seq):
        """Oversized contig: sequential exact-C path."""
        from ..gene_finder import GeneFinder
        if self.is_meta:
            gf = GeneFinder(
                meta=True, metagenomic_bins=self.bins,
                closed=self.closed, mask=self.mask,
                min_mask=self.min_mask, min_gene=self.min_gene,
                min_edge_gene=self.min_edge_gene,
                max_overlap=self.max_overlap,
                backend="refcore",   # never back into this runner
            )
        else:
            gf = GeneFinder(
                training_info=self.bins[0].training_info,
                closed=self.closed, mask=self.mask,
                min_mask=self.min_mask, min_gene=self.min_gene,
                min_edge_gene=self.min_edge_gene,
                max_overlap=self.max_overlap,
                backend="refcore",
            )
        gf._num_seq = num_seq
        return gf.find_genes(str(seq))

    # bins whose device (f32) path score sits within this margin of the
    # winner are re-run on the exact engine too (f32 drift vs the f64 C
    # anchor measured <= ~2e-5 relative; the margin is deliberately wide)
    @staticmethod
    def _margin(best):
        return 1.0 + 1e-4 * abs(best)

    def _produce_winner(self, seq, num_seq, cands, nodes_by_tt):
        """Exact finishing for one contig.

        `cands`: [(bin_id, device_score)] — the device sweep's per-bin
        path scores.  The winning bin (and any bin within the f32 drift
        margin of it) is re-run through the exact f64 C engine —
        score_nodes + star pointers + the full DP + finishing — so the
        emitted genes are byte-exact Prodigal semantics for the selected
        model by construction (reference sweep: lib.pyx:5339-5374)."""
        genes = Genes()
        genes._num_seq = num_seq
        genes.meta = self.is_meta
        genes.sequence = seq
        best_dev = max(s for _b, s in cands)
        close = sorted(b for b, s in cands
                       if s >= best_dev - self._margin(best_dev))
        max_score = -100.0
        chosen = None
        for b in close:                     # ascending bin order, like the
            tinf = self.bins[b].training_info   # reference's > sweep
            nodes = self._score_winner(seq, nodes_by_tt, b)
            # pre-DP scored snapshot == the reference's post-sweep rescore
            out_nodes = nodes.copy() if self.is_meta else None
            ipath = nodes.dynamic_programming(tinf, final=True)
            if nodes.length > 0 and ipath >= 0 \
                    and nodes.score[ipath] > max_score:
                max_score = nodes.score[ipath]
                chosen = (b, nodes, ipath, out_nodes)
        if chosen is None:
            genes.nodes = Nodes()
            genes.metagenomic_bin = None
            genes.training_info = None
            return genes
        return self._finish(genes, seq, *chosen)

    def _produce_empty(self, seq, num_seq):
        genes = Genes()
        genes._num_seq = num_seq
        genes.meta = self.is_meta
        genes.sequence = seq
        genes.nodes = Nodes()
        genes.metagenomic_bin = None
        genes.training_info = None
        return genes

    def find_genes_batch(self, sequences, num_seq_start=1):
        contigs, preps = [], []
        for s in sequences:
            seq = Sequence(s, mask=self.mask, mask_size=self.min_mask)
            contigs.append(seq)
            preps.append(self.pool.submit(self._prepare_contig, seq))

        futures = {}
        per_contig = []
        mega_launches = []
        mega_groups = []         # dispatched packed launches, FIFO
        mega_open = []           # open (still packing) groups
        mega_pending = {}        # ci -> un-pulled mega item count
        nodes_maps = {}

        def dispatch_group(gr):
            gr["fut"] = self.pool.submit(self._sweep_mega_multi,
                                         gr["items"])
            mega_groups.append(gr)
        for ci, fut in enumerate(preps):
            cand, geoms, nodes_by_tt, route = fut.result()
            self.route_counts[route] += 1
            if route == "c":
                futures[ci] = self.pool.submit(
                    self._produce_fallback, contigs[ci], num_seq_start + ci)
            elif not cand:
                futures[ci] = self.pool.submit(
                    self._produce_empty, contigs[ci], num_seq_start + ci)
            elif route == "mega":
                nodes_maps[ci] = nodes_by_tt
                by_tt = {}
                for b in cand:
                    tt = self.bins[b].training_info.translation_table
                    by_tt.setdefault(tt, []).append(b)
                for tt, bs in by_tt.items():
                    g = geoms[tt]
                    if "cdigits" in g:
                        # gap-compacted window sources are per-contig:
                        # keep the single-geometry launch for those
                        entries = []
                        for base in range(0, len(bs), 16):
                            rows = bs[base:base + 16]
                            fut = self.pool.submit(self._sweep_mega, g,
                                                   rows)
                            entries.append({"fut": fut, "rows": rows})
                        mega_launches.append((ci, entries))
                    else:
                        # streaming packer: groups dispatch as they fill,
                        # so the device works while later preps run
                        mega_pending[ci] = mega_pending.get(ci, 0) + 1
                        full = self._mega_add(
                            mega_open, {"ci": ci, "g": g, "rows": bs})
                        if full is not None:
                            dispatch_group(full)
            else:
                nodes_maps[ci] = nodes_by_tt
                per_contig.append((ci, cand, geoms, nodes_by_tt))

        # flush the still-open packed groups
        for gr in mega_open:
            dispatch_group(gr)

        # pack launches: a contig's bins never split across launches, and
        # each contig takes one winner slot (slots <= max_geoms because
        # every contig also consumes >= 1 geometry slot)
        launches = []      # each: {"work", "geoms", "slots"}
        cur_work, cur_geoms, cur_slots = [], {}, {}
        for ci, cand, geoms, _nbt in per_contig:
            tts = {self.bins[b].training_info.translation_table
                   for b in cand}
            if cur_work and (
                len(cur_work) + len(cand) > self.batch_size
                or len(cur_geoms) + len(tts) > self.max_geoms
            ):
                launches.append({"work": cur_work, "geoms": cur_geoms,
                                 "slots": cur_slots})
                cur_work, cur_geoms, cur_slots = [], {}, {}
            cur_slots[ci] = len(cur_slots)
            for b in cand:
                tt = self.bins[b].training_info.translation_table
                key = (ci, tt)
                if key not in cur_geoms:
                    cur_geoms[key] = geoms[tt]
                cur_work.append((ci, b, key))
        if cur_work:
            launches.append({"work": cur_work, "geoms": cur_geoms,
                             "slots": cur_slots})

        # dispatch every std launch asynchronously; the device pipelines
        for L in launches:
            L["dev"] = self._sweep(L["work"], L["geoms"])

        # pull in order — while the host finishes launch k's contigs, the
        # device is already computing launch k+1; each pull is one (BT,)
        # bitcast best-score vector
        def submit(ci, cands):
            if not cands or max(s for _b, s in cands) <= -100.0:
                futures[ci] = self.pool.submit(
                    self._produce_empty, contigs[ci], num_seq_start + ci)
            else:
                futures[ci] = self.pool.submit(
                    self._produce_winner, contigs[ci], num_seq_start + ci,
                    cands, nodes_maps[ci])

        # mega launches were dispatched first — pull them in dispatch
        # order, handing each contig to the exact-C winner finishing as
        # soon as its LAST item arrives, while the device still runs
        # later launches
        mega_cands = {}
        compacted_cis = {ci for ci, _e in mega_launches}
        for gr in mega_groups:
            dev, rows, CP, B = gr["fut"].result()
            bests = np.asarray(dev).view(np.float32).reshape(CP, B)
            pos = {b: i for i, b in enumerate(rows)}
            for k, it in enumerate(gr["items"]):
                ci = it["ci"]
                mega_cands.setdefault(ci, []).extend(
                    (b, float(bests[k, pos[b]])) for b in it["rows"])
                mega_pending[ci] -= 1
                if mega_pending[ci] == 0 and ci not in compacted_cis:
                    submit(ci, mega_cands.pop(ci))
        for ci, entries in mega_launches:      # compacted singles
            cands = mega_cands.pop(ci, [])
            for e in entries:
                dev, _NT = e["fut"].result()
                bests = np.asarray(dev).view(np.float32)
                cands.extend(
                    (b, float(bests[k])) for k, b in enumerate(e["rows"]))
            submit(ci, cands)

        for L in launches:
            bests = np.asarray(L["dev"]).view(np.float32)
            cands_by_contig = {}
            for k, (ci, b, _g) in enumerate(L["work"]):
                cands_by_contig.setdefault(ci, []).append(
                    (b, float(bests[k])))
            for ci in L["slots"]:
                submit(ci, cands_by_contig.get(ci, []))

        return [futures[ci].result() for ci in range(len(contigs))]
