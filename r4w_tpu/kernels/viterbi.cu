// Viterbi decoder for rate-1/R feed-forward convolutional codes with
// constraint length 3 <= K <= 7, as two XLA FFI custom calls.
//
// Trellis convention (fec/convolutional.py): state = previous K-1 input
// bits with the newest at the MSB, so target state s' = b*half + m has
// exactly the predecessors 2m and 2m+1 (half = 2^(K-2)).
//
// r4w_viterbi_forward: one warp per frame. Lane m keeps the metrics of
//   states m and m+half in registers and computes the two targets m and
//   m+half from predecessors 2m, 2m+1, fetched with warp shuffles. Soft
//   inputs are read 32 steps at a time (one coalesced load per lane) and
//   broadcast by shuffle. Each step's decisions are packed with two
//   ballots into one 64-bit word (bit s' = 1 iff predecessor 2m+1 won,
//   ties go to 2m); each lane buffers the word of one step and the warp
//   writes 32 steps at once.
// r4w_viterbi_traceback: one thread per frame walks the packed words
//   backwards from the given start state.
//
// The arithmetic is that of the plain lax.scan decoder: per-codeword
// correlation metrics sum_r x_r * (1 - 2*bit_r), candidate = metric +
// branch metric, strict '>' for the decision. Both are exact float32
// operations in the same order, so decisions are bit-identical.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int R>
__global__ void ViterbiForwardKernel(const float* __restrict__ rx,
                                     const int32_t* __restrict__ code_of,
                                     int64_t frames, int64_t steps,
                                     int half,
                                     uint32_t* __restrict__ dec,
                                     float* __restrict__ final_metrics) {
  const int64_t frame =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (frame >= frames) return;  // uniform across the warp

  const bool active = lane < half;
  const int m = active ? lane : 0;
  // predecessors 2m and 2m+1 live on lanes src and src+1, in the slot
  // that says whether the predecessor is >= half
  const int src = (2 * m) & (half - 1);
  const bool hi_slot = (2 * m) >= half;
  // codeword index per (predecessor, input bit)
  const int c00 = code_of[(2 * m) * 2 + 0];
  const int c10 = code_of[(2 * m + 1) * 2 + 0];
  const int c01 = code_of[(2 * m) * 2 + 1];
  const int c11 = code_of[(2 * m + 1) * 2 + 1];

  float lo = (lane == 0) ? 0.0f : -1e9f;  // metric of state m
  float hi = -1e9f;                       // metric of state m + half

  const float* frx = rx + frame * steps * R;
  uint32_t* fdec = dec + frame * steps * 2;

  for (int64_t t0 = 0; t0 < steps; t0 += 32) {
    const int64_t n = (steps - t0) < 32 ? (steps - t0) : 32;
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = lane < n ? frx[(t0 + lane) * R + r] : 0.0f;
    }
    uint32_t my_w0 = 0, my_w1 = 0;
    for (int i = 0; i < n; ++i) {
      float x[R];
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = __shfl_sync(kFull, v[r], i);
      // correlation metric of codeword c: sum_r x_r * (1 - 2*bit_r(c)),
      // accumulated in r order like the reference's einsum
      auto bm = [&](int c) {
        float s = (c & 1) ? -x[0] : x[0];
#pragma unroll
        for (int r = 1; r < R; ++r) s = s + (((c >> r) & 1) ? -x[r] : x[r]);
        return s;
      };
      const float a_lo = __shfl_sync(kFull, lo, src);
      const float a_hi = __shfl_sync(kFull, hi, src);
      const float b_lo = __shfl_sync(kFull, lo, src + 1);
      const float b_hi = __shfl_sync(kFull, hi, src + 1);
      const float p0 = hi_slot ? a_hi : a_lo;  // metric of state 2m
      const float p1 = hi_slot ? b_hi : b_lo;  // metric of state 2m+1
      // target m (input bit 0) and target m + half (input bit 1)
      const float q0 = p0 + bm(c00), q1 = p1 + bm(c10);
      const float r0 = p0 + bm(c01), r1 = p1 + bm(c11);
      const bool d0 = q1 > q0;
      const bool d1 = r1 > r0;
      lo = d0 ? q1 : q0;
      hi = d1 ? r1 : r0;
      const uint32_t mask = half >= 32 ? kFull : ((1u << half) - 1u);
      const uint64_t b0 = __ballot_sync(kFull, active && d0) & mask;
      const uint64_t b1 = __ballot_sync(kFull, active && d1) & mask;
      const uint64_t word = b0 | (b1 << half);
      if (lane == i) {
        my_w0 = static_cast<uint32_t>(word);
        my_w1 = static_cast<uint32_t>(word >> 32);
      }
    }
    if (lane < n) {
      reinterpret_cast<uint2*>(fdec)[t0 + lane] = make_uint2(my_w0, my_w1);
    }
  }
  if (active) {
    final_metrics[frame * 2 * half + lane] = lo;
    final_metrics[frame * 2 * half + lane + half] = hi;
  }
}

__global__ void ViterbiTracebackKernel(const uint32_t* __restrict__ dec,
                                       const int32_t* __restrict__ start,
                                       int64_t frames, int64_t steps,
                                       int half, int shift,
                                       int32_t* __restrict__ bits) {
  const int64_t frame =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (frame >= frames) return;
  const uint32_t* fdec = dec + frame * steps * 2;
  int32_t* fbits = bits + frame * steps;
  int state = start[frame];
  for (int64_t t = steps - 1; t >= 0; --t) {
    const uint32_t word = fdec[t * 2 + (state >> 5)];
    const int j = (word >> (state & 31)) & 1;
    fbits[t] = state >> shift;
    state = 2 * (state & (half - 1)) + j;
  }
}

ffi::Error CheckLaunch() {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

// rx: (..., T, R) f32; code_of: (S, 2) s32.
// dec: (..., T, 2) u32; final_metrics: (..., S) f32.
ffi::Error ViterbiForwardImpl(cudaStream_t stream,
                              ffi::Buffer<ffi::F32> rx,
                              ffi::Buffer<ffi::S32> code_of,
                              ffi::ResultBuffer<ffi::U32> dec,
                              ffi::ResultBuffer<ffi::F32> final_metrics) {
  auto rdims = rx.dimensions();
  auto cdims = code_of.dimensions();
  if (rdims.size() < 2 || cdims.size() < 2) {
    return ffi::Error::InvalidArgument("rx must be (..., T, R)");
  }
  const int64_t r = rdims[rdims.size() - 1];
  const int64_t steps = rdims[rdims.size() - 2];
  const int64_t s = cdims[cdims.size() - 2];
  const int half = static_cast<int>(s / 2);
  if (half < 2 || half > 32 || (half & (half - 1)) != 0) {
    return ffi::Error::InvalidArgument("need 3 <= K <= 7");
  }
  if (steps == 0) return ffi::Error::Success();
  const int64_t frames = rx.element_count() / (steps * r);
  if (frames == 0) return ffi::Error::Success();
  const int threads = 128;  // four frames per block
  const int64_t blocks = (frames * 32 + threads - 1) / threads;
  const float* x = rx.typed_data();
  const int32_t* c = code_of.typed_data();
  uint32_t* d = dec->typed_data();
  float* fm = final_metrics->typed_data();
  switch (r) {
    case 1:
      ViterbiForwardKernel<1><<<blocks, threads, 0, stream>>>(
          x, c, frames, steps, half, d, fm);
      break;
    case 2:
      ViterbiForwardKernel<2><<<blocks, threads, 0, stream>>>(
          x, c, frames, steps, half, d, fm);
      break;
    case 3:
      ViterbiForwardKernel<3><<<blocks, threads, 0, stream>>>(
          x, c, frames, steps, half, d, fm);
      break;
    case 4:
      ViterbiForwardKernel<4><<<blocks, threads, 0, stream>>>(
          x, c, frames, steps, half, d, fm);
      break;
    default:
      return ffi::Error::InvalidArgument("need 1 <= R <= 4");
  }
  return CheckLaunch();
}

// dec: (..., T, 2) u32; start: (...) s32 -> bits (..., T) s32.
ffi::Error ViterbiTracebackImpl(cudaStream_t stream,
                                ffi::Buffer<ffi::U32> dec,
                                ffi::Buffer<ffi::S32> start,
                                ffi::ResultBuffer<ffi::S32> bits,
                                int32_t half) {
  auto ddims = dec.dimensions();
  if (ddims.size() < 2 || ddims[ddims.size() - 1] != 2) {
    return ffi::Error::InvalidArgument("dec must be (..., T, 2)");
  }
  if (half < 2 || half > 32 || (half & (half - 1)) != 0) {
    return ffi::Error::InvalidArgument("need 3 <= K <= 7");
  }
  const int64_t steps = ddims[ddims.size() - 2];
  if (steps == 0) return ffi::Error::Success();
  const int64_t frames = start.element_count();
  if (frames == 0) return ffi::Error::Success();
  int shift = 0;
  while ((1 << shift) < half) ++shift;
  const int threads = 128;
  const int64_t blocks = (frames + threads - 1) / threads;
  ViterbiTracebackKernel<<<blocks, threads, 0, stream>>>(
      dec.typed_data(), start.typed_data(), frames, steps, half, shift,
      bits->typed_data());
  return CheckLaunch();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(R4wViterbiForward, ViterbiForwardImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(R4wViterbiTraceback, ViterbiTracebackImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("half"));
