# Port copy of centrifuger_tpu.build (host code, no accelerator).
"""Index build orchestration: genomes + taxonomy dumps -> native index files.

Mirrors Builder::Build (reference Builder.hpp:86-265): taxonomy init, genome
streaming/compaction with per-sequence filters (--subset-tax subtree filter,
duplicate-seqid dedup, short-genome filter, --concat-tax-genome grouping),
genome-boundary selected rows, FM build, sampled-SA -> seqid transform, and the
4-part index output (FM / taxonomy / seq-lengths / metadata, mirroring
prefix.{1,2,3,4}.cfr, Builder.hpp:280-313).

Native index layout: <prefix>.fm.npz, <prefix>.tax.npz, <prefix>.seqlen.npz,
<prefix>.meta.json.
"""

import json
import os
import sys
import time

import numpy as np

from .fm.builder import FMBuildParams, build_fm
from .io.readers import ReadFiles
from .spans import span
from .taxonomy import Taxonomy
from .taxonomy.taxonomy import _file_base_name
from .utils import make_encode_table, DNA_ALPHABET, PROTEIN_ALPHABET
from . import VERSION_STRING


def log(msg):
    sys.stderr.write("[%s] %s\n" % (time.strftime("%a %b %d %H:%M:%S %Y"), msg))


def build_index(genome_files, taxonomy_file, name_table, conversion_table,
                conversion_at_file_level, output_prefix,
                concat_same_taxid=False, ignore_uncategorized=False,
                subset_tax=0, params=None, protein=False, checkpoint=False,
                build_mem=0, bmax=None, dcv=None, threads=1, row_map=None):
    params = params or FMBuildParams()
    alphabet = PROTEIN_ALPHABET if protein else DNA_ALPHABET
    if protein:
        params.has_end_marker = True
        if params.precompute_width == 10:
            params.precompute_width = 4
    encode = make_encode_table(alphabet)
    end_code = 0 if protein else None

    tax = Taxonomy.from_dumps(taxonomy_file, name_table, conversion_table,
                              conversion_at_file_level)

    selected_taxids = None
    if subset_tax:
        selected_taxids = tax.get_children_tax(tax.compact_tax_id(subset_tax))

    reads = ReadFiles()
    for gf in genome_files:
        reads.add_read_file(gf)

    seq_length = {}
    genome_seqids = []
    genome_lens = []
    chunks = []
    taxid_chunks = {}  # for --concat-tax-genome

    file_ind = [0]

    def iter_with_file():
        for fi, fn in enumerate(reads.file_names):
            from .io.readers import _open_any, parse_fastx
            with _open_any(fn) as stream:
                for read in parse_fastx(stream):
                    yield fn, read

    for fn, read in iter_with_file():
        if conversion_at_file_level:
            seqid = tax.seq_name_to_seq_id(_file_base_name(fn))
        else:
            seqid = tax.seq_name_to_seq_id(read.id)

        if selected_taxids is not None:
            taxid = tax.seq_id_to_tax_id(seqid)
            if taxid not in selected_taxids:
                continue

        if not conversion_at_file_level and seqid in seq_length:
            continue  # duplicate seqid: already stored (Builder.hpp:129-130)

        if seqid >= tax.seq_cnt:
            sys.stderr.write("WARNING: taxonomy id doesn't exist for %s!\n" %
                             (_file_base_name(fn) if conversion_at_file_level else read.id))
            if not ignore_uncategorized:
                seqid = tax.add_extra_seq_name(
                    _file_base_name(fn) if conversion_at_file_level else read.id)
            else:
                continue

        raw = np.frombuffer(read.seq.encode(), dtype=np.uint8)
        codes = encode[raw]
        codes = codes[codes != 255]
        if end_code is not None:
            codes = np.concatenate([codes, [end_code]]).astype(np.uint8)
        ln = len(codes)
        if ln < params.precompute_width + 1:
            sys.stderr.write("WARNING: %s is filtered due to its short length "
                             "(could be from masker)!\n" % read.id)
            continue

        if not concat_same_taxid:
            if seqid not in seq_length:
                seq_length[seqid] = ln
                genome_seqids.append(seqid)
                genome_lens.append(ln)
                chunks.append(codes)
            else:  # file-level conversion: same file accumulates
                seq_length[seqid] += ln
                genome_lens[-1] += ln
                chunks.append(codes)
        else:
            taxid = tax.seq_id_to_tax_id(seqid)
            taxid_chunks.setdefault(taxid, []).append(codes)
            seq_length[seqid] = ln

    if concat_same_taxid:
        seq_length = {}
        tax.set_tax_id_as_seq_id()
        chunks = []
        genome_seqids = []
        genome_lens = []
        for taxid in sorted(taxid_chunks):
            cat = np.concatenate(taxid_chunks[taxid])
            if len(cat) == 0:
                continue
            chunks.append(cat)
            genome_seqids.append(taxid)
            genome_lens.append(len(cat))
            seq_length[taxid] = len(cat)
        log("Finish concatenating genomes")

    if not genome_lens:
        sys.stderr.write("ERROR: found 0 genomes in the input or after filtering.\n")
        sys.exit(1)

    codes = np.concatenate(chunks)
    chunks = taxid_chunks = None     # the codes are all in `codes` now
    log("Found %d sequences with total length %d bp." % (len(genome_lens), len(codes)))

    # serving accelerator: precompute the per-row LF-walk result (one-gather
    # SA resolution on device) when the 4 bytes/char cost is acceptable.
    # Clamped below 2^31 so the device's int32 rowmap gather can never wrap.
    rowmap_max = min(int(os.environ.get("CFR_ROWMAP_MAX", 1 << 28)),
                     (1 << 31) - 1)
    if row_map is None:
        row_map = len(codes) <= rowmap_max
    params.row_map = bool(row_map) and len(codes) < (1 << 31)

    # Two build paths:
    #  * whole-text SA-IS (native/sais.cpp, linear time) — fastest when the
    #    ~17 bytes/char working set fits in RAM;
    #  * memory-bounded chunked build (fm/sa_external.py + native/
    #    sa_chunked.cpp) honoring --build-mem/--bmax/--dcv/-t with
    #    ~10%-granularity checkpoint/resume — the reference's FMBuilder
    #    capability (compactds/FMBuilder.hpp:371-438,444-811). -t > 1 takes
    #    it too, for the parallel sort; a missing toolchain raises.
    explicit_chunked = bool(build_mem) or bmax is not None or \
        dcv is not None or \
        len(codes) > int(os.environ.get("CFR_CHUNKED_BUILD_THRESHOLD",
                                        1 << 30)) or \
        os.environ.get("CFR_CHUNKED_BUILD", "") == "1"
    if explicit_chunked or threads > 1:
        from .fm.builder import build_fm_streaming
        fm = build_fm_streaming(
            codes, genome_lens, genome_seqids, alphabet, params,
            dcv=dcv or 4096, bmax=bmax or (1 << 24), threads=threads,
            build_mem=build_mem,
            checkpoint_prefix=output_prefix if checkpoint else None, log=log)
    else:
        # --checkpoint on the SA-IS path: persist the suffix array (the
        # expensive stage) so an interrupted build resumes without re-sorting
        precomputed_sa = None
        ckpt_path = output_prefix + "_checkpoint.npz"
        if checkpoint:
            import hashlib
            digest = hashlib.sha256(codes.tobytes()).hexdigest()[:16]
            if os.path.exists(ckpt_path):
                z = np.load(ckpt_path)
                if str(z["digest"]) == digest:
                    precomputed_sa = z["sa"]
                    log("Resuming from checkpoint (suffix array cached).")
            if precomputed_sa is None:
                from .fm.suffix_array import suffix_array
                precomputed_sa = suffix_array(codes, len(alphabet))
                np.savez(ckpt_path, digest=digest, sa=precomputed_sa)
                log("Checkpoint written after suffix sort.")

        fm = build_fm(codes, genome_lens, genome_seqids, alphabet, params,
                      precomputed_sa=precomputed_sa)
        if checkpoint and os.path.exists(ckpt_path):
            os.remove(ckpt_path)
    log("FM index built; saving.")

    save_index(output_prefix, fm, tax, seq_length, protein)
    log("centrifuger-build finishes.")
    return fm, tax, seq_length


def save_index(prefix, fm, tax, seq_length, protein):
    fm.save(prefix + ".fm.npz")
    if getattr(fm, "rowmap", None) is not None:
        np.savez(prefix + ".rowmap.npz", rowmap=fm.rowmap)
    tax.save(prefix + ".tax.npz")
    keys = np.array(sorted(seq_length), dtype=np.int64)
    vals = np.array([seq_length[k] for k in keys], dtype=np.int64)
    np.savez(prefix + ".seqlen.npz", keys=keys, vals=vals)
    meta = {
        "version": VERSION_STRING,
        "SA_sample_rate": fm.sample_rate,
        "sequence_type": "amino_acid" if protein else "nucleotide",
        "build_date": time.strftime("%c"),
        "row_map": bool(getattr(fm, "rowmap", None) is not None),
    }
    with open(prefix + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)


def load_index(prefix):
    """(fm, taxonomy, seq lengths, meta) of the index at prefix; its time
    counts into the process totals as the span load.index (spans.py)."""
    from .fm.index import FMIndexData
    with span("load.index"):
        fm = FMIndexData.load(prefix + ".fm.npz")
        fm.source_prefix = prefix   # enables the wide-row disk cache (fm/device.py)
        if os.path.exists(prefix + ".rowmap.npz"):
            fm.rowmap = np.load(prefix + ".rowmap.npz")["rowmap"]
        tax = Taxonomy.load(prefix + ".tax.npz")
        z = np.load(prefix + ".seqlen.npz")
        seq_length = dict(zip(z["keys"].tolist(), z["vals"].tolist()))
        with open(prefix + ".meta.json") as f:
            meta = json.load(f)
    return fm, tax, seq_length, meta


def load_index_tax_only(prefix):
    """Load only taxonomy + seq lengths (for quant/inspect; mirrors reading
    just the .2/.3.cfr files)."""
    tax = Taxonomy.load(prefix + ".tax.npz")
    z = np.load(prefix + ".seqlen.npz")
    seq_length = dict(zip(z["keys"].tolist(), z["vals"].tolist()))
    return tax, seq_length


def is_protein_index(prefix):
    try:
        with open(prefix + ".meta.json") as f:
            return json.load(f).get("sequence_type") == "amino_acid"
    except OSError:
        return False
