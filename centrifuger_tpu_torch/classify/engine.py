"""Host wrapper for the fused device classification program (PyTorch).

Port of centrifuger_tpu.classify.engine_fused.ClassifierFused, which derives
from the non-fused engine (classify/engine_unfused.py) as ClassifierFused
derives from engine_jax.ClassifierJax.  Per batch the host packs the
reads 2 bits per base plus a validity mask, uploads them, runs the device
program (classify/device_engine.py), pulls ONE flat int32 blob (packed rows +
the flagged units' chains) and formats results.  Units the device flags
(hit-boundary-adjustment candidates, row-budget overflows, more best seqids
than it returns) take the exact host path, reusing the device chains, with
their backward searches (K5) and SA resolves (K2) batched on the device.
A protein index takes the translated search: the host joins the mates'
bytes, the device translates each into six amino-acid code lanes (K13),
chooses frame and strand, and flagged units have no boundary adjustment.
The batches the fused program cannot take (-k 0, --hitk-factor 0, a read
over L_MAX) go to the non-fused engine on the same device.  On an int64 index the flagged units' chains ship
in the blob as lo and hi int32 words of each int64 (sp, ep, l, off).

Serving loops, as the JAX engine's: query_pipelined_packed (packed results to
TSV lines), query_pipelined (one result object a read: the CLI's read-prep
routes), and the bulk FASTQ route, iter_prepacked on a producer thread (one
native parse-and-pack pass a batch) feeding serve_tsv_prepacked, which
uploads and dispatches on the serving thread and formats on the finish
workers.  They and query_batch are one loop, _pipeline: up to PIPELINE_DEPTH
batches the fused program takes (_fused_takes) in flight, drained before
any other batch goes to the non-fused engine.

Every batch is numbered at dispatch and timed by stage (spans.py): on the
serving thread engine.pack, engine.upload and engine.launch (grouped in the
records under engine.dispatch), engine.finish_wait and engine.unfused; on
the finish workers finish.pull, finish.fallback and finish.format (grouped
under finish.batch).  Each batch adds its seconds to stats["<stage>_s"]
for every stage of STAGES (0 s where it did not run one), one to
stats["batches"], and its units to stats["fast_units"] /
["fallback_units"]: the serving thread adds the engine.* stages when it
hands the batch's result on, the finish worker the finish.* stages and the
unit counts when its finish ends, each under one lock.

Bit-identical to ClassifierNP / the reference binary; enforced by the golden
TSV tests.
"""

import itertools
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .engine_np import ClassifierResult, BWTHit
from .engine_unfused import ClassifierTorchUnfused, _round_up
from .device_engine import fused_classify, fused_classify_protein, translate_lanes, U_CAP
from .translate import frame_table
from .. import spans
from ..io.fastq_fast import iter_packed_batches

ENGINE_STAGES = ("engine.pack", "engine.upload", "engine.launch", "engine.finish_wait",
                 "engine.unfused")
FINISH_STAGES = ("finish.pull", "finish.fallback", "finish.format")
STAGES = ENGINE_STAGES + FINISH_STAGES


def _as_results(queries, results):
    return results


def _as_packed(queries, results):
    return None, dict(enumerate(results)), queries


class ClassifierTorch(ClassifierTorchUnfused):
    K_OUT = 8        # best seqids returned per read by the device (= U_CAP)
    U_CAP = U_CAP    # per-read SA-row budget on the device
    L_MAX = 8192     # max read length on the fused path (int32 score bound)
    PIPELINE_DEPTH = 8

    def __init__(self, fm, taxonomy, param, protein=False, dev=None,
                 device="cuda", serve_layout="plain", force_idtype=None):
        super().__init__(fm, taxonomy, param, protein=protein, dev=dev,
                         device=device, serve_layout=serve_layout,
                         force_idtype=force_idtype)
        self.stats.update(fallback_units=0, batches=0)
        self.stats.update((name + "_s", 0.0) for name in STAGES)
        self._batch_no = itertools.count()
        self._sid_prefix = None
        self._pool = None
        self._held = None        # the last submitted batch's "released" event
        self._frame_table = torch.from_numpy(frame_table(self.encode)).to(self.device) \
            if protein else None

    def _fused_ok(self):
        return self.param.max_result > 0 and \
            self.param.max_result_per_hit_factor > 0

    def _fused_takes(self, queries, lengths=None):
        """Whether the fused program takes a batch: -k and --hitk-factor above
        0 and no read over L_MAX, the longest taken from `lengths` where the
        batch carries them (the bulk route's)."""
        if not self._fused_ok():
            return False
        if lengths is not None:
            return int(lengths.max(initial=0)) <= self.L_MAX
        return not any(len(r1) > self.L_MAX or (r2 is not None and len(r2) > self.L_MAX)
                       for r1, r2 in queries)

    # --------------------------------------------------------------- batching

    def _pack_reads(self, queries):
        """queries -> ((pack2, vmask) 2-bit-packed reads, lengths [U] int32,
        nr, L) as numpy arrays, U = len(queries) * nr (engine_fused.
        _pack_reads).  The JAX engine pads the unit count to a power of two
        for its compile cache; nothing here is compiled per shape, so there
        is no padding.  L keeps its rounding (_encode_reads): it sets the hit
        capacity H = L // (mhl + 1) + 1, which the results depend on."""
        nr = 2 if any(q[1] is not None for q in queries) else 1
        raws = []
        for r1, r2 in queries:
            raws.append(r1)
            if nr == 2:
                raws.append(r2 if r2 is not None else b"")
        codes, lens, _, _ = self._encode_reads(raws)
        U, L = codes.shape
        valid = codes != 255
        cc = np.where(valid, codes, 0).astype(np.uint8).reshape(U, L // 4, 4)
        pack2 = (cc[:, :, 0] | (cc[:, :, 1] << 2) | (cc[:, :, 2] << 4)
                 | (cc[:, :, 3] << 6)).astype(np.uint8)
        vmask = np.packbits(valid, axis=1, bitorder="little")
        return (pack2, vmask), lens, nr, L

    def _pack_reads_protein_flat(self, queries):
        """queries -> (flat uint8: every mate's bytes joined in unit order,
        starts int32 [R + 1] the mates' offsets in it, nr, L), R =
        len(queries) * nr: the fused engine's protein pack, whose lanes the
        card builds (device_engine.translate_lanes).  An empty or None mate
        is an empty entry.  nr and L are _pack_reads_protein's: the longest
        lane is frame 0 of the longest mate."""
        nr = 2 if any(q[1] is not None for q in queries) else 1
        raws = [b"" if r is None else r for q in queries for r in q[:nr]]
        lens = np.fromiter(map(len, raws), np.int32, len(raws))
        starts = np.zeros(len(raws) + 1, np.int32)
        np.cumsum(lens, out=starts[1:])
        flat = np.frombuffer(bytearray(b"".join(raws)), np.uint8)
        L = max(_round_up(int(lens.max(initial=0)) // 3, 32), 32)
        return flat, starts, nr, L

    def _tally(self):
        """A new batch's number and stage seconds (spans.Tally)."""
        return spans.Tally(STAGES, next(self._batch_no))

    def _dispatch_fused(self, queries):
        t = self._tally()
        with t.span("engine.dispatch"):
            with t.span("engine.pack"):
                if self.protein:
                    flat, starts, nr, L = self._pack_reads_protein_flat(queries)
                    reads = (flat, starts)
                else:
                    (pack2, vmask), lengths, nr, L = self._pack_reads(queries)
                    reads = (pack2, vmask, lengths)
            return self._launch(t, reads, nr, L, queries)

    def _dispatch_packed(self, queries, reads, lengths, nr):
        """Dispatch from host-packed numpy arrays, reads = (pack2, vmask) as
        _pack_reads or the native producer (io/fastq_fast.py) gives them: the
        upload and the launch run on the calling (serving) thread, so a
        producer thread that packs never touches a CUDA tensor
        (engine_fused._dispatch_packed).  Nucleotide indexes only."""
        t = self._tally()
        with t.span("engine.dispatch"):
            return self._launch(t, (*reads, lengths), nr, reads[0].shape[1] * 4, queries)

    def _launch(self, t, reads, nr, L, queries):
        """Upload a packed batch (reads: (pack2, vmask, lengths), or the
        protein path's (flat, starts)) and launch the device program, lanes
        of L codes; returns the batch's ctx, its tally t in it.  The protein
        program's code lanes are translated on the reads' device first
        (K13), before a sharded index splits them by units.  It first waits
        until the batch submitted last to the finish workers has let its
        device outputs go (finish_packed), so that batches coming faster than
        a finish worker reaches them do not stack their outputs on the card;
        the wait shows in the engine.dispatch record, under no counter."""
        if self._held is not None:
            self._held.wait()
        with t.span("engine.upload"):
            dev_reads = [self._upload(a) for a in reads]
        mhl = self.param.min_hit_len
        H = max(L // (mhl + 1) + 1, 1)
        with t.span("engine.launch"):
            if self.protein:
                program = fused_classify_protein
                # the mates' bytes are freed before the chain's outputs exist
                dev_reads = list(translate_lanes(*dev_reads, L, self._frame_table))
            else:
                program = fused_classify
            out = program(
                self.dev, *dev_reads, nr, mhl, H,
                self.param.max_result, self.param.max_result_per_hit_factor,
                self.K_OUT, len(queries) * self.U_CAP)
        return dict(queries=queries, out=out, nr=nr, t=t, released=threading.Event())

    def _pull_results(self, out):
        """ONE device->host transfer: unpack host_blob (packed + fb_units +
        fb_hits + fb_nh) into numpy arrays.  int64 fb_hits ship as two int32
        words each (lo, hi) and are read back whole."""
        blob = out["host_blob"].cpu().numpy()
        q, w = out["packed"].shape
        packed = blob[:q * w].reshape(q, w)
        rest = blob[q * w:]
        fb = out["fb_units"].shape[0]
        hshape = tuple(out["fb_hits"].shape)
        words = out["fb_hits"].element_size() // 4
        nfw = int(np.prod(hshape)) * words
        fbh = rest[fb:fb + nfw].copy().view(np.int64 if words == 2 else np.int32)
        fbn = rest[fb + nfw:fb + nfw + out["fb_nh"].shape[0]]
        return packed, dict(out, fb_units=rest[:fb], fb_hits=fbh.reshape(hshape),
                            fb_nh=fbn)

    def finish_packed(self, ctx):
        """(packed [Q, 5+K] numpy, {unit: ClassifierResult} for the
        fallback units).  The batch's device outputs are let go (taken out of
        ctx) once the flagged units' chains are on the host, before the host
        work of the fallback; then ctx["released"] is set, which the next
        dispatch waits on (_launch)."""
        queries, nr, t = ctx["queries"], ctx["nr"], ctx["t"]
        try:
            with t.span("finish.pull"):
                packed, out = self._pull_results(ctx.pop("out"))
            fb_idx = np.flatnonzero((packed[:, 4] != 0) | (packed[:, 3] > self.K_OUT))
            t.counts.update(fallback_units=int(len(fb_idx)),
                            fast_units=int(len(queries) - len(fb_idx)))
            fb = {}
            with t.span("finish.fallback"):
                if len(fb_idx):
                    hits_at = self._fallback_hits_accessor(out, fb_idx, nr)
                    out = None
                    ctx["released"].set()
                    fb = self._finish_fallback_units(queries, fb_idx, hits_at, nr)
        finally:
            ctx["released"].set()
        return packed, fb

    def _finish_fused(self, ctx):
        """Materialize ClassifierResult objects for one dispatched batch."""
        packed, fb = self.finish_packed(ctx)
        param, tax, kmax = self.param, self.tax, self.param.max_result
        results = []
        for qi, (r1, r2) in enumerate(ctx["queries"]):
            if qi in fb:
                results.append(fb[qi])
                continue
            res = ClassifierResult()
            res.query_length = len(r1) + (len(r2) if r2 is not None else 0)
            nb = int(packed[qi, 3])
            res.score = int(packed[qi, 0])
            res.secondary_score = res.score if nb > 1 else int(packed[qi, 1])
            res.hit_length = int(packed[qi, 2])
            ids = [int(s) for s in packed[qi, 5:5 + nb]]
            if nb <= kmax:
                for sid in ids:
                    res.seq_names.append(tax.seq_id_to_name(sid))
                    res.tax_ids.append(tax.orig_tax_id(tax.seq_id_to_tax_id(sid)))
                    if param.output_expanded_result:
                        res.expanded_strings.append("")
            else:
                from ..taxonomy import rank_string
                promoted, children = tax.reduce_tax_ids(
                    [tax.seq_id_to_tax_id(sid) for sid in ids], kmax,
                    want_children=param.output_expanded_result)
                for i, t in enumerate(promoted):
                    res.seq_names.append(rank_string(tax.tax_rank(t)))
                    res.tax_ids.append(tax.orig_tax_id(t))
                    if param.output_expanded_result:
                        if children is not None and len(children) == len(promoted):
                            res.expanded_strings.append(",".join(
                                str(tax.orig_tax_id(c)) for c in children[i]))
                        else:
                            res.expanded_strings.append("")
            results.append(res)
        return results

    # ----------------------------------------------------- batched fallbacks

    def _fallback_hits_accessor(self, out, fb_idx, nr):
        """hits_at(lane) -> [(sp, ep, l, off), ...] for the flagged units'
        lanes: from the fb_* arrays shipped in the blob when they cover every
        flagged unit, else one gather of the flagged lanes on the device."""
        lpu = (6 if self.protein else 2) * nr
        sel = out["fb_units"][:len(fb_idx)]
        if len(fb_idx) <= len(out["fb_units"]) and np.array_equal(sel, fb_idx):
            hs, ns = out["fb_hits"], out["fb_nh"]
            pos = {int(u): i for i, u in enumerate(sel)}

            def index(lane):
                return pos[lane // lpu] * lpu + lane % lpu
        else:
            lanes = (lpu * fb_idx[:, None] + np.arange(lpu)[None, :]).reshape(-1)
            lt = torch.from_numpy(lanes).to(out["hits"].device)
            hs = out["hits"][lt].cpu().numpy()
            ns = out["nhits"][lt].cpu().numpy()
            lmap = {int(l): i for i, l in enumerate(lanes)}
            index = lmap.__getitem__

        def hits_at(lane):
            i = index(lane)
            return [tuple(int(v) for v in hs[i, m]) for m in range(int(ns[i]))]
        return hits_at

    def _finish_fallback_units(self, queries, fb_idx, hits_at, nr):
        """Exact host finalize for flagged units, their chains read through
        hits_at (_fallback_hits_accessor): one prefix_search dispatch serves
        every boundary-adjustment search, one resolve dispatch every SA row
        (protein units have no boundary adjustment)."""
        unit_hits = self._fallback_unit_hits_protein if self.protein \
            else self._fallback_unit_hits_dna
        return self._classify_units_batch(unit_hits(queries, fb_idx, hits_at, nr))

    def _fallback_unit_hits_protein(self, queries, fb_idx, hits_at, nr):
        """Flagged protein units: the frame and strand choice
        (_translated_choice) on the device chains.  Returns [(qi, hits,
        qlen), ...]."""
        res = []
        for qi in map(int, fb_idx):
            r1, r2 = queries[qi]
            chosen = self._translated_choice(hits_at, 6 * nr * qi, r2 is not None and nr == 2)
            res.append((qi, [BWTHit(*h, s) for h, s in chosen],
                        len(r1) + (len(r2) if r2 is not None else 0)))
        return res

    # ------------------------------------------------------------ main entry

    def _unfused_batch(self, queries):
        """A batch the fused program cannot take (-k 0, --hitk-factor 0, a
        read over L_MAX): the non-fused engine on the same device, as
        ClassifierFused hands it to ClassifierJax.  One batch of its own,
        timed as engine.unfused."""
        t = self._tally()
        with t.span("engine.unfused"):
            results = super().query_batch(queries)
        self._add_stats(t.seconds, STAGES, batches=1)
        return results

    def query_batch(self, queries):
        [results] = self._pipeline([(queries, None, (), ())], self._dispatch_fused,
                                   self._finish_fused, _as_results)
        return results

    def _finish_pool(self):
        """Finish-stage workers: batch i's result pull, fallback dispatches
        and TSV formatting overlap batch i+1's upload and device work."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=4, thread_name_prefix="finish")
        return self._pool

    def _finish(self, fn, ctx, *args):
        """fn(ctx, *args), a batch's finish (on a finish worker), recorded as
        finish.batch; then its finish.* seconds and unit counts join stats."""
        t = ctx["t"]
        with t.span("finish.batch"):
            res = fn(ctx, *args)
        self._add_stats(t.seconds, FINISH_STAGES, **t.counts)
        return res

    def _submit(self, fn, ctx, *args):
        """(the batch's tally, the future of its finish on the workers)."""
        self._held = ctx["released"]
        return ctx["t"], self._finish_pool().submit(self._finish, fn, ctx, *args)

    def _collect(self, t, fut):
        """The finish's result, the wait for it timed as engine.finish_wait;
        then the batch's engine.* seconds join stats."""
        with t.span("engine.finish_wait"):
            res = fut.result()
        self._add_stats(t.seconds, ENGINE_STAGES, batches=1)
        return res

    def _finish_packed_ctx(self, ctx):
        packed, fb = self.finish_packed(ctx)
        return packed, fb, ctx["queries"]

    def _pipeline(self, items, dispatch, finish, shape):
        """The one serving loop under query_batch, query_pipelined,
        query_pipelined_packed and serve_tsv_prepacked; yields a result a
        batch, in order.  items yields (queries, lengths or None, dargs,
        fargs).  A batch the fused program takes (_fused_takes) is dispatched
        on this thread (dispatch(queries, *dargs) gives its ctx) and finished
        on the workers (finish(ctx, *fargs)), up to PIPELINE_DEPTH batches in
        flight.  Any other batch first drains those, then goes to the
        non-fused engine (none for an empty batch), whose results are yielded
        as shape(queries, results, *fargs)."""
        pend = deque()
        for queries, lengths, dargs, fargs in items:
            if len(queries) and self._fused_takes(queries, lengths):
                pend.append(self._submit(finish, dispatch(queries, *dargs), *fargs))
                if len(pend) >= self.PIPELINE_DEPTH:
                    yield self._collect(*pend.popleft())
                continue
            while pend:
                yield self._collect(*pend.popleft())
            # the bulk route's LazyQueries iterate lengths only: index them
            batch = [queries[i] for i in range(len(queries))]
            yield shape(batch, self._unfused_batch(batch) if batch else [], *fargs)
        while pend:
            yield self._collect(*pend.popleft())

    def query_pipelined_packed(self, batches):
        """Yields (packed, fallback_dict, queries) per batch, in order;
        dispatch and finish overlap across up to PIPELINE_DEPTH batches.  A
        batch the fused program does not take, or an empty one, has packed
        None and every result in fallback_dict."""
        return self._pipeline(((b, None, (), ()) for b in batches), self._dispatch_fused,
                              self._finish_packed_ctx, _as_packed)

    def query_pipelined(self, batches):
        """Yields one result list per batch, in order (engine_fused.
        query_pipelined): batch i's finish and result objects overlap batch
        i+1's upload and device work.  The CLI's per-read-result routes
        (barcodes, UMIs, --un / --cl, sample sheets, --expand-taxid) take it."""
        return self._pipeline(((b, None, (), ()) for b in batches), self._dispatch_fused,
                              self._finish_fused, _as_results)

    # --------------------------------------------------- bulk FASTQ serving

    def iter_prepacked(self, path, batch_size):
        """Producer-side batches for serve_tsv_prepacked from one FASTQ file:
        (read ids, queries, (pack2, vmask), lengths, nr), packed by one native
        C pass a batch (native/fastqpack.cpp); the batches the C parser
        refuses come from the Python reader and are packed by _pack_reads
        (engine_fused.iter_prepacked).  Runs on a producer thread: numpy
        only.  A protein index packs six frames a read and has no such route."""
        if self.protein:
            raise ValueError("the prepacked route is for nucleotide indexes")
        for ids, queries, reads, lengths, nr in iter_packed_batches(path, batch_size):
            if reads is None:
                reads, lengths, nr, _ = self._pack_reads(queries)
            yield ids, queries, reads, lengths, nr

    def finish_tsv_ctx(self, ctx, read_ids):
        """Worker-side finish and TSV formatting of a dispatched batch:
        (lines, classified count, reads)."""
        packed, fb = self.finish_packed(ctx)
        with ctx["t"].span("finish.format"):
            lines, ncls = self.format_tsv_batch(packed, fb, ctx["queries"], read_ids)
        return lines, ncls, len(ctx["queries"])

    def serve_tsv_prepacked(self, items):
        """The bulk serving loop (engine_fused.serve_tsv_prepacked): `items`
        yields iter_prepacked's tuples, typically from a producer thread;
        yields (lines, classified count, reads) a batch, in order.  The
        serving thread uploads and dispatches; result pulls, fallbacks and
        TSV formatting run on the finish workers.  A batch the fused program
        cannot take (-k 0, --hitk-factor 0, a read over L_MAX) goes to the
        non-fused engine, as query_pipelined_packed hands it."""
        return self._pipeline(
            ((queries, lengths, (reads, lengths, nr), (ids,))
             for ids, queries, reads, lengths, nr in items),
            self._dispatch_packed, self.finish_tsv_ctx, self._unfused_tsv)

    def _unfused_tsv(self, queries, results, read_ids):
        """serve_tsv_prepacked's tuple of the non-fused engine's results."""
        lines, ncls = self.format_tsv_batch(None, dict(enumerate(results)), queries, read_ids)
        return lines, ncls, len(queries)

    def _tsv_tables(self):
        """Per-seqid TSV fragment "\\t<name>\\t<taxid>\\t"."""
        if self._sid_prefix is None:
            tax = self.tax
            self._sid_prefix = [
                "\t%s\t%d\t" % (name, tax.orig_tax_id(tax.seq_id_to_tax_id(s)))
                for s, name in enumerate(tax.seq_names)]
        return self._sid_prefix

    def format_tsv_batch(self, packed, fb, queries, read_ids):
        """TSV rows for the default column set, byte-identical to
        ResultWriter.output over materialized results.  Returns (lines,
        classified_count)."""
        tax = self.tax
        kmax = self.param.max_result
        lines = []
        ap = lines.append
        ncls = 0
        if packed is None:
            packed = np.zeros((0, 5 + self.K_OUT), np.int32)
        n_dev = len(packed)
        sid_prefix = self._tsv_tables()
        nb_l = packed[:, 3].tolist()
        sc_l = packed[:, 0].tolist()
        se_l = packed[:, 1].tolist()
        hl_l = packed[:, 2].tolist()
        s1_l = packed[:, 5].tolist()
        check_fb = bool(fb) or n_dev < len(queries)
        for qi, (r1, r2) in enumerate(queries):
            rid = read_ids[qi]
            if check_fb and (qi >= n_dev or qi in fb):
                res = fb[qi]
                qlen = res.query_length
                m = len(res.tax_ids)
                if m == 0:
                    ap("%s\tunclassified\t0\t0\t0\t0\t%d\t1" % (rid, qlen))
                    continue
                ncls += 1
                for i in range(m):
                    ap("%s\t%s\t%d\t%d\t%d\t%d\t%d\t%d" % (
                        rid, res.seq_names[i], res.tax_ids[i], res.score,
                        res.secondary_score, res.hit_length, qlen, m))
                continue
            qlen = len(r1) + (len(r2) if r2 is not None else 0)
            nb = nb_l[qi]
            if nb == 0:
                ap("%s\tunclassified\t0\t0\t0\t0\t%d\t1" % (rid, qlen))
                continue
            ncls += 1
            if nb == 1:
                ap("%s%s%d\t%d\t%d\t%d\t1" % (
                    rid, sid_prefix[s1_l[qi]], sc_l[qi], se_l[qi],
                    hl_l[qi], qlen))
                continue
            score = sc_l[qi]
            second = score  # nb > 1 -> second best equals best
            hitlen = hl_l[qi]
            if nb <= kmax:
                for j in range(nb):
                    sid = int(packed[qi, 5 + j])
                    ap("%s%s%d\t%d\t%d\t%d\t%d" % (
                        rid, sid_prefix[sid], score, second, hitlen, qlen, nb))
            else:
                from ..taxonomy import rank_string
                ctids = [tax.seq_id_to_tax_id(int(packed[qi, 5 + j]))
                         for j in range(nb)]
                promoted, _ = tax.reduce_tax_ids(ctids, kmax, want_children=False)
                m = len(promoted)
                for t in promoted:
                    ap("%s\t%s\t%d\t%d\t%d\t%d\t%d\t%d" % (
                        rid, rank_string(tax.tax_rank(t)), tax.orig_tax_id(t),
                        score, second, hitlen, qlen, m))
        return lines, ncls
