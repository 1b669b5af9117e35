// Host emulation of the CUDA DP kernel (agatha_jax/cuda/dp.cuh).
//
// Runs the kernel body unchanged, one std::thread per CUDA thread of a
// block, with the warp shuffle, warp max and block barrier emulated
// through shared buffers and a std::barrier.  Exposed as an XLA FFI
// handler for the host platform so the tests can drive the same
// jax.ffi call the gpu route makes.  Build:
//   g++ -std=c++20 -O2 -shared -fPIC -I <jax.ffi.include_dir()> \
//       -I agatha_jax/cuda -o libdp_host.so dp_host.cc -lpthread

#include <algorithm>
#include <barrier>
#include <string>
#include <thread>
#include <vector>

#include "dp.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

struct Block {
  explicit Block(int n) : n(n), bar(n), ex{std::vector<int32_t>(n),
                                            std::vector<int32_t>(n)},
                          xchg(2 * (n / 32)) {}
  int n;
  std::barrier<> bar;
  std::vector<int32_t> ex[2];  // double-buffered exchange slots
  std::vector<agatha::Xchg> xchg;
};

struct HostCtx {
  Block* b;
  int tid;
  mutable int phase = 0;
  int lane() const { return tid & 31; }
  int warp() const { return tid >> 5; }
  int nwarp() const { return b->n >> 5; }
  // One barrier per exchange: a thread can run at most one barrier
  // ahead, so alternating buffers keep every read intact.
  const int32_t* exchange(int32_t v) const {
    std::vector<int32_t>& buf = b->ex[phase];
    phase ^= 1;
    buf[tid] = v;
    b->bar.arrive_and_wait();
    return buf.data() + (tid & ~31);
  }
  int32_t shfl_prev(int32_t v) const {
    return exchange(v)[(lane() + 31) & 31];
  }
  int32_t warp_max(int32_t v) const {
    const int32_t* w = exchange(v);
    return *std::max_element(w, w + 32);
  }
  void sync() const { b->bar.arrive_and_wait(); }
  agatha::Xchg* xchg() const { return b->xchg.data(); }
};

ffi::Error DpHost(ffi::Buffer<ffi::S32> meta, ffi::Buffer<ffi::U8> tcodes,
                  ffi::Buffer<ffi::U8> qfwd, ffi::ResultBuffer<ffi::S32> out,
                  int64_t match, int64_t mismatch, int64_t gap_oe,
                  int64_t gap_extend, int64_t slice_width,
                  int64_t z_threshold, int64_t band_width, int64_t w_state,
                  int64_t safe16) {
  const auto td = tcodes.dimensions();
  const auto qd = qfwd.dimensions();
  const int64_t gb = td[0];
  const int threads = (int)(w_state / agatha::kRows);
  if (w_state % 256 != 0 || threads > agatha::kMaxThreads) {
    return ffi::Error::InvalidArgument("w_state " + std::to_string(w_state));
  }
  agatha::Params p{(int32_t)match, (int32_t)mismatch, (int32_t)gap_oe,
                   (int32_t)gap_extend, (int32_t)slice_width,
                   (int32_t)z_threshold, (int32_t)band_width,
                   (int32_t)(td[1] * 2), (int32_t)(qd[1] * 2),
                   (int32_t)w_state};
  const int32_t* m = meta.typed_data();
  for (int64_t b = 0; b < gb; ++b) {
    Block blk(threads);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) {
      ts.emplace_back([&, t] {
        HostCtx cx{&blk, t};
        const uint8_t* trow = tcodes.typed_data() + b * (p.wt / 2);
        const uint8_t* qrow = qfwd.typed_data() + b * (p.qf / 2);
        int32_t* o = out->typed_data() + 4 * b;
        if (safe16) {
          agatha::align_pair<true>(cx, p, m[2 * b], m[2 * b + 1], trow,
                                   qrow, o);
        } else {
          agatha::align_pair<false>(cx, p, m[2 * b], m[2 * b + 1], trow,
                                    qrow, o);
        }
      });
    }
    for (auto& t : ts) t.join();
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(AgathaDpHost, DpHost,
                              ffi::Ffi::Bind()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int64_t>("match")
                                  .Attr<int64_t>("mismatch")
                                  .Attr<int64_t>("gap_oe")
                                  .Attr<int64_t>("gap_extend")
                                  .Attr<int64_t>("slice_width")
                                  .Attr<int64_t>("z_threshold")
                                  .Attr<int64_t>("band_width")
                                  .Attr<int64_t>("w_state")
                                  .Attr<int64_t>("safe16"));
