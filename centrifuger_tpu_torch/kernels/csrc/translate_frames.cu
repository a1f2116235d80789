// translate_frames: the protein engine's six-frame translation, kernel K13.
//
// Replaces no TPU kernel.  The JAX package translates on the host
// (centrifuger_tpu/classify/engine_fused.py _pack_reads_protein, with
// classify/translate.py translate_frames), and so did the port's fused
// engine (classify/engine.py _pack_reads_protein), about 200 us of Python a
// read pair on the serving thread.  On the fused protein path the host now
// joins the mates' bytes (engine.py _pack_reads_protein_flat) and this kernel
// builds the code lanes that chain_search_lanes takes: per mate the forward
// frames 0-2, then frames 0-2 of the reverse complement, each frame its
// whole codons only, 255 past a lane's end.
//
// The rules are the host's, as lookups (classify/translate.py frame_table):
// `table` holds the amino-acid code of each codon class (a, b, c), classes
// 0-3 for A, C, G and T (any byte other than A, C, G or N is a T) and 4 for N
// (a codon that holds one, like a stop codon, is 'A'), at 25 a + 5 b + c;
// then each byte's class on the forward strand and the class of its
// complement (Classifier::_compChar: any byte other than A, C, G, T becomes
// N) on the reverse one.
//
// Bound on this card: bytes.  A batch of 8,192 pairs of 2 x 150 bp reads
// 2.5 MB of mates and 65 KB of offsets and writes 98,304 lanes of 64 codes
// (6.3 MB) and their lengths, about 2.7 us at 3.35 TB/s; the lookups are a
// few integer operations a code.  A block waits on device memory twice: for
// the table and its offsets, then for its mates' bytes, one 16-byte load a
// thread (a run of 32 mates of 150 bytes is 300 loads).  On an H100 at 700 W
// it takes 31 us of device time, the same at 100 and 150 bytes a mate: what
// is left follows the lanes written (the output loop), not the bytes read.
//
// Design.  A block takes a run of consecutive mates, whose bytes are one
// contiguous range of `flat`: it stages each byte once in shared memory as
// its two class nibbles (forward low, reverse high), so a code costs three
// shared-memory reads and one table lookup.  The stage holds the whole
// 16-byte blocks of device memory that the range touches: each such block
// holds a byte of `flat`, so it lies in its allocation, which the CUDA and
// PyTorch allocators align to 256 and 512 bytes.  The run's output rows are one
// contiguous range of `codes` too: consecutive threads write consecutive
// 32-bit words, four codes of one lane each.  The run's length is chosen at
// the launch so that its mates fit the stage at the longest mate that L
// admits (3 L + 2 bytes); a byte past the stage (a caller whose L is short
// of its mates) is read from device memory, and a lane is cut at L codes.
#include <algorithm>

#include "fm_view.cuh"

namespace {

constexpr int TF_THREADS = 256;
constexpr int TF_FWD = 128;           // table: byte -> forward class
constexpr int TF_REV = 384;           // table: byte -> class of its complement
constexpr int TF_TABLE = 640;         // table bytes
constexpr int TF_MAX_MATES = 32;      // mates a block
constexpr int TF_STAGE = 32768;       // staged bytes a block (dynamic shared memory)

__device__ __forceinline__ uint32_t classes4(const uint8_t* tab, uint32_t w) {
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t b = (w >> (8 * k)) & 255;
    out |= (tab[TF_FWD + b] | (tab[TF_REV + b] << 4)) << (8 * k);
  }
  return out;
}

template <int Threads>
__global__ void __launch_bounds__(Threads)
translate_frames_kernel(const uint8_t* __restrict__ flat, const int32_t* __restrict__ starts,
                        const uint8_t* __restrict__ table, int R, int L, int mates,
                        int stage_cap, uint8_t* __restrict__ codes,
                        int32_t* __restrict__ lengths) {
  extern __shared__ __align__(16) uint8_t stage[];
  __shared__ uint8_t tab[TF_TABLE];
  __shared__ int32_t off[TF_MAX_MATES + 1];
  const int m0 = blockIdx.x * mates;
  const int nm = min(mates, R - m0);
  for (int i = threadIdx.x; i < TF_TABLE; i += Threads) tab[i] = table[i];
  for (int i = threadIdx.x; i <= nm; i += Threads) off[i] = starts[m0 + i];
  __syncthreads();
  const int base = off[0];
  const int staged = min(off[nm] - base, stage_cap);
  // flat[base] is stage[lead]: the stage starts at its 16-byte block
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(flat + base) & 15);
  const uint4* blocks = reinterpret_cast<const uint4*>(flat + base - lead);
  for (int i = threadIdx.x; i < (lead + staged + 15) / 16; i += Threads) {
    const uint4 v = __ldg(blocks + i);
    reinterpret_cast<uint4*>(stage)[i] = make_uint4(classes4(tab, v.x), classes4(tab, v.y),
                                                    classes4(tab, v.z), classes4(tab, v.w));
  }
  __syncthreads();

  auto classes = [&](int p) -> uint32_t {    // the byte at flat[base + p]
    if (p < staged) return stage[lead + p];
    const uint8_t b = __ldg(flat + base + p);
    return tab[TF_FWD + b] | (tab[TF_REV + b] << 4);
  };
  // a lane's codes: min(whole codons of its frame, L)
  auto lane_len = [&](int n, int frame) { return n > frame ? min((n - frame) / 3, L) : 0; };

  for (int t = threadIdx.x; t < 6 * nm; t += Threads) {
    const int j = t / 6, lane = t % 6;
    lengths[6 * static_cast<int64_t>(m0) + t] = lane_len(off[j + 1] - off[j], lane % 3);
  }
  const int W = L / 4;                        // words a lane
  uint32_t* out = reinterpret_cast<uint32_t*>(codes) + 6 * static_cast<int64_t>(m0) * W;
  for (int t = threadIdx.x; t < 6 * W * nm; t += Threads) {
    const int j = t / (6 * W), lane = (t / W) % 6, w = t % W;
    const int p0 = off[j] - base, n = off[j + 1] - off[j];
    const int frame = lane % 3;
    const int m = lane_len(n, frame);
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * w + k;
      uint32_t code = 255;
      if (c < m) {
        uint32_t a, b, d;
        if (lane < 3) {                       // forward: bytes f + 3c, +1, +2
          const int p = p0 + frame + 3 * c;
          a = classes(p) & 15;
          b = classes(p + 1) & 15;
          d = classes(p + 2) & 15;
        } else {                              // reverse complement: from the end
          const int p = p0 + n - 1 - frame - 3 * c;
          a = classes(p) >> 4;
          b = classes(p - 1) >> 4;
          d = classes(p - 2) >> 4;
        }
        code = tab[25 * a + 5 * b + d];
      }
      word |= code << (8 * k);
    }
    out[t] = word;
  }
}

}  // namespace

extern "C" int translate_frames_launch(const uint8_t* flat, const int32_t* starts,
                                       const uint8_t* table, int R, int L, uint8_t* codes,
                                       int32_t* lengths, cudaStream_t stream) {
  const int longest = 3 * L + 2;              // bytes of the longest mate L admits
  const int mates = std::max(1, std::min(TF_MAX_MATES, TF_STAGE / longest));
  const int stage_cap = std::min(mates * longest, TF_STAGE);
  const int blocks = (R + mates - 1) / mates;
  const int stage_bytes = (stage_cap + 15 + 15) / 16 * 16;   // the lead and the last block
  translate_frames_kernel<TF_THREADS><<<blocks, TF_THREADS, stage_bytes, stream>>>(
      flat, starts, table, R, L, mates, stage_cap, codes, lengths);
  return static_cast<int>(cudaGetLastError());
}
