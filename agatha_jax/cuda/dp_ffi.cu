// CUDA entry point of the DP kernel (dp.cuh) and its XLA FFI handler.
//
// Build (agatha_jax/cuda/__init__.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o libagatha_dp.so dp_ffi.cu

#include <cuda_runtime.h>

#include <string>

#include "dp.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

struct CudaCtx {
  agatha::Xchg* sm;
  __device__ __forceinline__ int lane() const { return threadIdx.x & 31; }
  __device__ __forceinline__ int warp() const { return threadIdx.x >> 5; }
  __device__ __forceinline__ int nwarp() const { return blockDim.x >> 5; }
  // value held by the previous lane of this warp (lane 0 reads lane 31)
  __device__ __forceinline__ int32_t shfl_prev(int32_t v) const {
    return __shfl_sync(0xffffffffu, v, (threadIdx.x + 31) & 31);
  }
  __device__ __forceinline__ int32_t warp_max(int32_t v) const {
    return __reduce_max_sync(0xffffffffu, v);
  }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ agatha::Xchg* xchg() const { return sm; }
};

template <bool SAFE16>
__global__ void __launch_bounds__(agatha::kMaxThreads)
    dp_kernel(agatha::Params p, const int32_t* __restrict__ meta,
              const uint8_t* __restrict__ tcodes,
              const uint8_t* __restrict__ qfwd, int32_t* __restrict__ out) {
  extern __shared__ agatha::Xchg xchg[];
  const int64_t b = blockIdx.x;
  agatha::align_pair<SAFE16>(CudaCtx{xchg}, p, meta[2 * b], meta[2 * b + 1],
                             tcodes + b * (p.wt / 2), qfwd + b * (p.qf / 2),
                             out + 4 * b);
}

ffi::Error DpImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> meta,
                  ffi::Buffer<ffi::U8> tcodes, ffi::Buffer<ffi::U8> qfwd,
                  ffi::ResultBuffer<ffi::S32> out, int64_t match,
                  int64_t mismatch, int64_t gap_oe, int64_t gap_extend,
                  int64_t slice_width, int64_t z_threshold,
                  int64_t band_width, int64_t w_state, int64_t safe16) {
  const auto md = meta.dimensions();
  const auto td = tcodes.dimensions();
  const auto qd = qfwd.dimensions();
  if (md.size() != 2 || td.size() != 2 || qd.size() != 2 || md[1] != 2 ||
      td[0] != md[0] || qd[0] != md[0]) {
    return ffi::Error::InvalidArgument("agatha_dp: bad bucket shapes");
  }
  const int64_t gb = md[0];
  const int64_t threads = w_state / agatha::kRows;
  if (w_state % 256 != 0 || threads > agatha::kMaxThreads) {
    return ffi::Error::InvalidArgument("agatha_dp: w_state " +
                                       std::to_string(w_state));
  }
  if (gb == 0) return ffi::Error::Success();
  agatha::Params p;
  p.match = (int32_t)match;
  p.mismatch = (int32_t)mismatch;
  p.goe = (int32_t)gap_oe;
  p.ge = (int32_t)gap_extend;
  p.sw = (int32_t)slice_width;
  p.z = (int32_t)z_threshold;
  p.bw = (int32_t)band_width;
  p.wt = (int32_t)(td[1] * 2);
  p.qf = (int32_t)(qd[1] * 2);
  p.w = (int32_t)w_state;
  const size_t smem = 2 * (threads / 32) * sizeof(agatha::Xchg);
  if (safe16) {
    dp_kernel<true><<<gb, threads, smem, stream>>>(
        p, meta.typed_data(), tcodes.typed_data(), qfwd.typed_data(),
        out->typed_data());
  } else {
    dp_kernel<false><<<gb, threads, smem, stream>>>(
        p, meta.typed_data(), tcodes.typed_data(), qfwd.typed_data(),
        out->typed_data());
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("agatha_dp launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(AgathaDp, DpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
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
