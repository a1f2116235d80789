// Port copy of centrifuger_tpu/native/fastqpack.cpp (host code, no accelerator).
// Native bulk FASTQ parse + 2-bit pack for the TSV serving fast path.
//
// One pass over plain 4-line FASTQ bytes produces exactly what the device
// upload wants: 2-bit packed codes (4 bases/byte, little-endian) + validity
// bitmask + lengths — the layout of ClassifierTorch._pack_reads — plus
// read-id byte spans (token to first space/tab, trailing /1 or /2 stripped;
// reference ReadFiles.hpp:82-90).  CRLF is normalized.  Returns -1 on
// anything unusual (multi-line records, overlong reads) so the caller can
// parse the rest of the file with the Python kseq-style reader.
//
//   n = fqp_batch(buf, len, off, max_reads, Lcap,
//                 pack2, vmask, lengths, id_ofs, id_len, sq_ofs,
//                 &consumed, &maxlen)
//
// sq_ofs gives each read's sequence byte offset in buf (length = lengths[i])
// so rare host-fallback paths can materialize raw reads lazily.
//
// pack2:  [max_reads, Lcap/4]  (callee zero-fills used rows)
// vmask:  [max_reads, Lcap/8]
// lengths:[max_reads]
// consumed: bytes of buf handled (next call resumes at off+consumed)

#include <cstdint>
#include <cstring>

namespace {

static const uint8_t* find_nl(const uint8_t* p, const uint8_t* end) {
  return (const uint8_t*)memchr(p, '\n', end - p);
}

struct Enc {
  uint8_t code[256];
  uint8_t valid[256];
  Enc() {
    // UPPERCASE-only, matching the engine's encode table (utils.py
    // make_encode_table) and the reference's read coding: lowercase bases
    // are out-of-alphabet characters in reads
    memset(code, 0, sizeof(code));
    memset(valid, 0, sizeof(valid));
    const char* alpha = "ACGT";
    for (int i = 0; i < 4; ++i) {
      code[(uint8_t)alpha[i]] = (uint8_t)i;
      valid[(uint8_t)alpha[i]] = 1;
    }
  }
};
static const Enc kEnc;

}  // namespace

extern "C" int64_t fqp_batch(const uint8_t* buf, int64_t len, int64_t off,
                             int64_t max_reads, int64_t Lcap, uint8_t* pack2,
                             uint8_t* vmask, int32_t* lengths,
                             int64_t* id_ofs, int64_t* id_len,
                             int64_t* sq_ofs,
                             int64_t* consumed, int64_t* maxlen) {
  const uint8_t* base = buf;
  const uint8_t* p = buf + off;
  const uint8_t* end = buf + len;
  const int64_t p4 = Lcap / 4, p8 = Lcap / 8;
  int64_t n = 0;
  *maxlen = 0;
  *consumed = 0;
  while (n < max_reads && p < end) {
    const uint8_t* rec = p;
    // ---- header line ----
    const uint8_t* nl1 = find_nl(p, end);
    if (!nl1) break;                      // incomplete record at buffer end
    if (*p != '@') return -1;
    const uint8_t* he = nl1;
    if (he > p && he[-1] == '\r') --he;
    // read id token
    const uint8_t* idp = p + 1;
    const uint8_t* ide = idp;
    while (ide < he && *ide != ' ' && *ide != '\t') ++ide;
    if (ide - idp >= 2 && ide[-2] == '/' &&
        (ide[-1] == '1' || ide[-1] == '2'))
      ide -= 2;
    // ---- sequence line ----
    const uint8_t* sq = nl1 + 1;
    const uint8_t* nl2 = find_nl(sq, end);
    if (!nl2) break;
    const uint8_t* se = nl2;
    if (se > sq && se[-1] == '\r') --se;
    int64_t slen = se - sq;
    if (slen > Lcap) return -1;
    // ---- separator line ----
    const uint8_t* pl = nl2 + 1;
    const uint8_t* nl3 = find_nl(pl, end);
    if (!nl3) break;
    if (pl >= end || *pl != '+') return -1;   // multi-line record
    // ---- quality line ----
    const uint8_t* ql = nl3 + 1;
    const uint8_t* nl4 = find_nl(ql, end);
    const uint8_t* qe;
    if (!nl4) {
      if (nl3 + 1 >= end) break;              // qual not in buffer yet
      qe = end;                               // final line without newline
      if (qe > ql && qe[-1] == '\r') --qe;
      if (qe - ql < slen) break;              // maybe truncated: stop here
      nl4 = end - 1;                          // consume to end
    } else {
      qe = nl4;
      if (qe > ql && qe[-1] == '\r') --qe;
    }
    if (qe - ql != slen) return -1;           // multi-line / ragged
    // ---- emit ----
    uint8_t* pk = pack2 + n * p4;
    uint8_t* vm = vmask + n * p8;
    memset(pk, 0, p4);
    memset(vm, 0, p8);
    for (int64_t i = 0; i < slen; ++i) {
      uint8_t ch = sq[i];
      pk[i >> 2] |= (uint8_t)(kEnc.code[ch] << ((i & 3) * 2));
      vm[i >> 3] |= (uint8_t)(kEnc.valid[ch] << (i & 7));
    }
    lengths[n] = (int32_t)slen;
    id_ofs[n] = idp - base;
    id_len[n] = ide - idp;
    sq_ofs[n] = sq - base;
    if (slen > *maxlen) *maxlen = slen;
    ++n;
    p = nl4 + 1;
  }
  *consumed = p - (buf + off);
  return n;
}

// Record splitter for the object route (io/readers.py ReadFiles): one pass
// over a chunk of strict 4-line FASTQ finds each complete record's fields,
// exactly as the line parser (io/readers.py parse_fastx) reads them.
//
//   n = fqp_records(buf, len, max_records, bounds, &consumed, &refused)
//
// bounds: [max_records, 8] byte offsets into buf, per record: name start and
// end (the header up to its first space or tab, a trailing /1 or /2
// dropped), comment start and end (the rest of the header after that one
// separator; -1, -1 where there is none), sequence start and end, quality
// start and end.  Trailing '\r's are dropped from the header and quality
// lines, one from the sequence line.  Blank lines where a header is due are
// skipped, as the line parser skips them.
//
// It stops at a record cut by the end of buf (refused = 0: the caller reads
// more and calls again from consumed) and refuses a record wherever the line
// parser could read the bytes differently (refused = 1): a header that does
// not start with '@' (FASTA, stray text), a sequence line that is empty,
// starts with '+' or has whitespace at either end (the parser strips it), a
// third line that does not start with '+', a quality line whose length
// differs from the sequence's (multi-line records), or any byte of 0x80 or
// above (the parser decodes lines as UTF-8).  consumed: the bytes of the
// records found (and of the blank lines before them).

namespace {

static inline bool strip_space(uint8_t c) {    // bytes.strip()'s whitespace
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' || c == '\f';
}

static inline uint8_t or_bytes(const uint8_t* p, const uint8_t* e) {
  uint8_t acc = 0;
  for (; p < e; ++p) acc |= *p;
  return acc;
}

}  // namespace

extern "C" int64_t fqp_records(const uint8_t* buf, int64_t len, int64_t max_records,
                               int64_t* bounds, int64_t* consumed, int64_t* refused) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  int64_t n = 0;
  *refused = 0;
  while (n < max_records && p < end) {
    // ---- header line ----
    const uint8_t* nl1 = find_nl(p, end);
    if (!nl1) break;
    const uint8_t* hs = p;
    while (hs < nl1 && *hs == '\r') ++hs;
    if (hs == nl1) {                          // a blank line: skipped, as there
      p = nl1 + 1;
      continue;
    }
    if (*p != '@') { *refused = 1; break; }
    hs = p + 1;
    const uint8_t* he = nl1;
    while (he > hs && he[-1] == '\r') --he;
    const uint8_t* cut = hs;
    while (cut < he && *cut != ' ' && *cut != '\t') ++cut;
    const uint8_t* ide = cut;
    if (ide - hs >= 2 && ide[-2] == '/' && (ide[-1] == '1' || ide[-1] == '2')) ide -= 2;
    // ---- sequence line ----
    const uint8_t* sq = nl1 + 1;
    const uint8_t* nl2 = find_nl(sq, end);
    if (!nl2) break;
    const uint8_t* se = nl2;
    if (se > sq && se[-1] == '\r') --se;
    if (se == sq || *sq == '+' || strip_space(*sq) || strip_space(se[-1])) {
      *refused = 1;
      break;
    }
    // ---- separator line ----
    const uint8_t* pl = nl2 + 1;
    const uint8_t* nl3 = find_nl(pl, end);
    if (!nl3) break;
    if (*pl != '+') { *refused = 1; break; }
    // ---- quality line ----
    const uint8_t* ql = nl3 + 1;
    const uint8_t* nl4 = find_nl(ql, end);
    if (!nl4) break;
    const uint8_t* qe = nl4;
    while (qe > ql && qe[-1] == '\r') --qe;
    if (qe - ql != se - sq ||
        ((or_bytes(hs, he) | or_bytes(sq, se) | or_bytes(ql, qe)) & 0x80)) {
      *refused = 1;
      break;
    }
    // ---- emit ----
    int64_t* b = bounds + n * 8;
    b[0] = hs - buf;
    b[1] = ide - buf;
    b[2] = cut < he ? cut + 1 - buf : -1;
    b[3] = cut < he ? he - buf : -1;
    b[4] = sq - buf;
    b[5] = se - buf;
    b[6] = ql - buf;
    b[7] = qe - buf;
    ++n;
    p = nl4 + 1;
  }
  *consumed = p - buf;
  return n;
}
