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
