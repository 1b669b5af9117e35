// Native host-side sequence encoder/packer.
//
// Analogue of the reference's pinned-host batch fill + device
// pack/revcomp kernels (AGAThA/src/host_batch.cpp:79-154,
// kernels/pack_rc_seqs.h:13-212): at scale the host must encode, pad,
// reverse/complement and nibble-pack millions of reads per second to
// keep the devices fed, so this path is C++.
//
// Semantics replicated exactly (see ops/packing.py):
//   * 4-bit code = ASCII & 0xF
//   * pad with 'N' (code 14) to a multiple of 8 bases
//   * op bit0: reverse over the FULL padded width (the reference's
//     trailing-N logic is dead code; see packing.py's module docstring)
//   * op bit1: complement A<->T (1<->4), C<->G (3<->7)
//
// Built as a plain shared object and called through ctypes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const uint8_t kNCode = 14;  // 'N' & 0xF

inline uint8_t complement(uint8_t c) {
  switch (c) {
    case 1: return 4;   // A -> T
    case 4: return 1;   // T -> A
    case 3: return 7;   // C -> G
    case 7: return 3;   // G -> C
    default: return c;
  }
}

// Run fn(lo, hi) over [0, n) split across a small thread pool — the
// analogue of the reference's OpenMP `-n` host parallelism
// (test_prog.cpp:195-214).  Sequential below kMinPar items (thread
// startup costs more than the work for small batches).
const int64_t kMinPar = 4096;

template <typename F>
void parallel_ranges(int64_t n, int32_t n_threads, F fn) {
  int64_t nt = n_threads > 0
                   ? n_threads
                   : (int64_t)std::thread::hardware_concurrency();
  if (nt > n / kMinPar + 1) nt = n / kMinPar + 1;
  if (nt <= 1) {
    fn((int64_t)0, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt - 1);
  const int64_t per = (n + nt - 1) / nt;
  for (int64_t t = 1; t < nt; ++t) {
    const int64_t lo = t * per;
    const int64_t hi = lo + per < n ? lo + per : n;
    if (lo < hi) pool.emplace_back([=] { fn(lo, hi); });
  }
  fn((int64_t)0, per < n ? per : n);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Encode a batch of ASCII sequences into padded 4-bit codes
// (one byte per code).
//
//   blob    : concatenated ASCII sequences
//   offsets : n+1 byte offsets into blob
//   ops     : per-sequence op byte (bit0 reverse, bit1 complement)
//   out     : (n, stride) row-major output, caller-zeroed or not
//             (rows are fully written up to padded length, rest
//             untouched)
//   stride  : bytes per output row; must be >= padded length of the
//             longest sequence
//   lens    : out, per-sequence unpadded length
//
// Returns 0 on success, -1 if any sequence exceeds stride.
int agatha_encode_batch(const uint8_t* blob, const int64_t* offsets,
                        const uint8_t* ops, int64_t n, uint8_t* out,
                        int64_t stride, int32_t* lens,
                        int32_t n_threads) {
  // pre-check so the parallel body cannot fail
  for (int64_t i = 0; i < n; ++i) {
    if (((offsets[i + 1] - offsets[i] + 7) & ~int64_t(7)) > stride) {
      return -1;
    }
  }
  parallel_ranges(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* __restrict__ seq = blob + offsets[i];
      const int64_t len = offsets[i + 1] - offsets[i];
      const int64_t padded = (len + 7) & ~int64_t(7);
      lens[i] = static_cast<int32_t>(len);
      uint8_t* __restrict__ row = out + i * stride;
      const uint8_t op = ops ? ops[i] : 0;
      if (op & 0x1) {  // reverse over padded width
        for (int64_t j = 0; j < len; ++j) {
          row[padded - 1 - j] = seq[j] & 0xF;
        }
        for (int64_t j = len; j < padded; ++j) {
          row[padded - 1 - j] = kNCode;
        }
      } else {
        for (int64_t j = 0; j < len; ++j) row[j] = seq[j] & 0xF;
        for (int64_t j = len; j < padded; ++j) row[j] = kNCode;
      }
      if (op & 0x2) {  // complement
        for (int64_t j = 0; j < padded; ++j) row[j] = complement(row[j]);
      }
    }
  });
  return 0;
}

// Nibble-pack rows of 4-bit codes: out byte j = row[2j] | row[2j+1]<<4.
// in: (n, stride) codes; out: (n, stride/2) packed. stride must be even.
int agatha_pack_nibbles(const uint8_t* in, int64_t n, int64_t stride,
                        uint8_t* out, int32_t n_threads) {
  if (stride % 2) return -1;
  const int64_t half = stride / 2;
  parallel_ranges(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* __restrict__ row = in + i * stride;
      uint8_t* __restrict__ orow = out + i * half;
      for (int64_t j = 0; j < half; ++j) {
        orow[j] =
            static_cast<uint8_t>(row[2 * j] | (row[2 * j + 1] << 4));
      }
    }
  });
  return 0;
}


}  // extern "C"
