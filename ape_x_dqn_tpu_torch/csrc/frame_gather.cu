// Frame-row gather for Hopper (sm_90a): out[i] = src[idx[i]].
//
// Replaces the TPU kernel ape_x_dqn_tpu/ops/frame_gather.py:46
// gather_rows_pallas (body _copy_row_kernel), which scalar-prefetched
// the indices into its BlockSpec index map and copied one row per grid
// step. Here each CUDA block loads its own index and copies one output
// row; nothing is carried between blocks.
//
// Rows are treated as `row_bytes` contiguous bytes, so any trailing
// shape and any dtype work. When row_bytes is a multiple of 16 and both
// base pointers are 16-byte aligned (the frame ring's 7168-byte rows),
// every thread moves 16-byte uint4 words; otherwise a byte-wise path
// runs (e.g. 6x6 = 36-byte rows).
//
// Indices are expected in [0, n_rows). Anything else is clamped into
// range, as JAX's gather clamps, so the kernel never reads out of
// bounds.
//
// What bounds it: pure memory traffic, M * row_bytes read plus
// M * row_bytes written (plus the M indices). On the frame-ring sample
// path M = K * B * stack = 4 * 512 * 4 = 8192 rows of 7168 bytes per
// side, about 117 MB per call, or about 35 us at the H100 SXM's
// published 3.35 TB/s. The design does nothing more about it yet than
// use full 16-byte accesses with neighbouring threads on neighbouring
// addresses; TMA or cp.async staging is later work.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded through ctypes (ape_x_dqn_tpu_torch/ops/frame_gather.py). The
// launch goes onto the caller's stream; the function returns
// cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename Idx>
__device__ __forceinline__ int64_t clamped_row(const Idx* __restrict__ idx,
                                               int64_t i, int64_t n_rows) {
  int64_t r = static_cast<int64_t>(idx[i]);
  r = r < 0 ? 0 : r;
  return r >= n_rows ? n_rows - 1 : r;
}

// One block per output row; each thread copies 16-byte words.
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_rows_vec16(const uint4* __restrict__ src, const Idx* __restrict__ idx,
                  uint4* __restrict__ out, int64_t n_rows, int64_t row_vecs) {
  const int64_t i = blockIdx.x;
  const int64_t r = clamped_row(idx, i, n_rows);
  const uint4* s = src + r * row_vecs;
  uint4* d = out + i * row_vecs;
#pragma unroll 4
  for (int64_t c = threadIdx.x; c < row_vecs; c += kThreads) {
    d[c] = s[c];
  }
}

// One block per output row; each thread copies single bytes.
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_rows_bytes(const uint8_t* __restrict__ src, const Idx* __restrict__ idx,
                  uint8_t* __restrict__ out, int64_t n_rows,
                  int64_t row_bytes) {
  const int64_t i = blockIdx.x;
  const int64_t r = clamped_row(idx, i, n_rows);
  const uint8_t* s = src + r * row_bytes;
  uint8_t* d = out + i * row_bytes;
  for (int64_t c = threadIdx.x; c < row_bytes; c += kThreads) {
    d[c] = s[c];
  }
}

template <typename Idx>
void launch(const void* src, const void* idx, void* out, int64_t n_rows,
            int64_t m, int64_t row_bytes, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(m));
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    gather_rows_vec16<Idx><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint4*>(src), static_cast<const Idx*>(idx),
        static_cast<uint4*>(out), n_rows, row_bytes / 16);
  } else {
    gather_rows_bytes<Idx><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(src), static_cast<const Idx*>(idx),
        static_cast<uint8_t*>(out), n_rows, row_bytes);
  }
}

}  // namespace

// src [n_rows, row_bytes] bytes, idx [m] int32 (idx_is_64 = 0) or int64
// (idx_is_64 = 1), out [m, row_bytes] bytes. m must be in
// [1, 2^31 - 1] and n_rows >= 1 (the wrapper checks both).
extern "C" int gather_rows_launch(const void* src, const void* idx,
                                  int idx_is_64, void* out, int64_t n_rows,
                                  int64_t m, int64_t row_bytes,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_is_64) {
    launch<int64_t>(src, idx, out, n_rows, m, row_bytes, s);
  } else {
    launch<int32_t>(src, idx, out, n_rows, m, row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}
