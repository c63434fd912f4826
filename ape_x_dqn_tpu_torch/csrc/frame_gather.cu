// Frame-row gather for Hopper (sm_90a): out[i] = src[idx[i]].
//
// Replaces the TPU kernel ape_x_dqn_tpu/ops/frame_gather.py:46
// gather_rows_pallas (body _copy_row_kernel), which scalar-prefetched
// the indices into its BlockSpec index map and copied one row per grid
// step.
//
// Rows are treated as `row_bytes` contiguous bytes, so any trailing
// shape and any dtype work. Indices are expected in [0, n_rows);
// anything else is clamped into range, as JAX's gather clamps, so the
// kernel never reads out of bounds. Offsets are 64-bit: the sources
// (a 10.3 GB frame ring, 29.7 GB flat replay leaves) pass 2^32 bytes.
//
// What bounds it: bytes. A call reads M * row_bytes and writes as much
// (plus the M indices), with no arithmetic: on the frame-ring path
// M = K * B * stack = 4 * 512 * 4 = 8192 rows of 7168 B, on the flat
// path 2048 rows of 28,288 B, about 116 MB either way, 35 us at the
// H100 SXM's published 3.35 TB/s. The card's own contiguous copy of the
// same bytes takes about 41.6 us, and this kernel on sequential indices
// about as long, so the aim is copy speed; random rows cost 1-2% more.
//
// The design (rows a multiple of 16 bytes, both base pointers 16-byte
// aligned):
// - Work units of at most 7168 bytes: a row is cut into the fewest
//   chunks of equal size (16-byte multiples), so the 7168-byte frame
//   rows are one unit and the 28,288-byte stacks four of 7072; both
//   paths give 8192 units.
// - A persistent grid of as many blocks as the card holds at once (the
//   SM count times the blocks an SM's shared memory allows: 2 of
//   112 KB on an H100), each walking units with a stride of the grid.
// - One thread per block drives a ring of 16 chunk buffers in shared
//   memory with TMA bulk copies (cp.async.bulk): a load completes on
//   its stage's mbarrier, a store goes back as a bulk group, and a
//   stage is refilled once its store has read it (wait_group.read), so
//   15 loads stay in flight per block, about 28 MB over the card (more
//   blocks with 4 or 8 stages ran 1-3% slower; one block of 31 stages
//   per SM 3-12% slower, paced by its one thread's serial ring).
// - Both copies carry an L2 evict_first policy: every byte passes once,
//   and without it the gather ran 3-6% slower.
// - The block reads its own indices, one unit ahead of their use.
// Other rows, or pointers that are not 16-byte aligned, take a
// byte-wise path: one block per row, one byte a thread (36-byte rows).
//
// What lost (one H100 80GB HBM3 at 700 W, one run of chip_smoke.py and
// tools/gather_sweep.py as of commit 0d21cab; numbers in PERF.md): a
// register design on the same persistent grid (a warp per unit, each
// thread issuing 8 uint4 loads before its stores) was 2.0% slower at
// the frame ring and 5.9-6.5% slower at the flat sites; the one block
// per row it replaced ran level with index_select, which this design
// beat in that run by about 2% at the frame ring and 2-4% at the flat
// sites (in a later run: level at the frame ring, 2-3% at the flat).
//
// Built with nvcc into a shared library with a plain C interface and
// loaded through ctypes (ape_x_dqn_tpu_torch/ops/frame_gather.py). The
// launch goes onto the caller's stream and reports its error to the
// caller. The launch geometry (the shared-memory opt-in, the SM count
// and the occupancy) is queried once per device, kernel and ring size
// and cached, so a launch makes no CUDA runtime query: it costs the
// same host time inside a CUDA graph capture as outside one.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kByteThreads = 128;  // byte path: one block per row
constexpr int kMaxChunk = 7168;    // bytes one work unit moves at most
constexpr int kStages = 16;        // chunks a block keeps in flight

template <typename Idx>
__device__ __forceinline__ int64_t clamped_row(const Idx* __restrict__ idx,
                                               int64_t i, int64_t n_rows) {
  int64_t r = static_cast<int64_t>(idx[i]);
  r = r < 0 ? 0 : r;
  return r >= n_rows ? n_rows - 1 : r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  const uint32_t one = 1;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(one)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// global -> shared: `bytes` (a multiple of 16) completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar),
      "l"(policy)
      : "memory");
}

// shared -> global, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;\n"
      ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes),
      "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Persistent grid. Work unit u is chunk (u % chunks_per_row) of output
// row u / chunks_per_row; block b moves units b, b + grid, b + 2 grid,
// ... through a ring of kStages chunk buffers in shared memory. One
// thread runs the ring: it waits for a chunk's load, stores it back
// with a bulk copy and refills the buffer of the previous unit once
// that unit's store has read it, so kStages - 1 loads stay in flight.
template <typename Idx>
__global__ void __launch_bounds__(32)
gather_rows_bulk(const uint8_t* __restrict__ src, const Idx* __restrict__ idx,
                 uint8_t* __restrict__ out, int64_t n_rows, int64_t row_bytes,
                 int64_t units, int64_t chunk, int64_t chunks_per_row) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  if (threadIdx.x != 0) return;
  // every byte is read or written once: keep it from evicting anything
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  const int64_t first = blockIdx.x, step = gridDim.x;
  const int64_t mine = (units - first + step - 1) / step;
  for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // the k-th unit of this block: its output row, byte offset and size
  auto row_of = [&](int64_t k) { return (first + k * step) / chunks_per_row; };
  auto off_of = [&](int64_t k) {
    return (first + k * step - row_of(k) * chunks_per_row) * chunk;
  };
  auto bytes_of = [&](int64_t k) {
    const int64_t left = row_bytes - off_of(k);
    return static_cast<uint32_t>(left < chunk ? left : chunk);
  };
  auto src_of = [&](int64_t k) {
    return src + clamped_row(idx, row_of(k), n_rows) * row_bytes + off_of(k);
  };
  auto load = [&](int64_t k, int s, const uint8_t* from) {
    bulk_load(smem_u32(ring + s * chunk), from, bytes_of(k),
              smem_u32(&full[s]), policy);
  };

  for (int k = 0; k < kStages && k < mine; ++k) load(k, k, src_of(k));
  int64_t ahead = kStages;  // the next unit to load, into stage `ls`
  int ls = 0;
  // its index is read one unit early, so the read is off the ring's path
  const uint8_t* ahead_src = ahead < mine ? src_of(ahead) : nullptr;
  int s = 0;
  uint32_t phase = 0;
  for (int64_t k = 0; k < mine; ++k) {
    mbar_wait(smem_u32(&full[s]), phase);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_store(out + row_of(k) * row_bytes + off_of(k),
               smem_u32(ring + s * chunk), bytes_of(k), policy);
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
    if (k >= 1 && ahead < mine) {
      // unit k - 1's stage, once its store (all but the newest group)
      // has read it
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(ahead, ls, ahead_src);
      if (++ls == kStages) ls = 0;
      if (++ahead < mine) ahead_src = src_of(ahead);
    }
  }
  // shared memory must outlive the last stores
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One block per output row; each thread copies single bytes.
template <typename Idx>
__global__ void __launch_bounds__(kByteThreads)
gather_rows_bytes(const uint8_t* __restrict__ src, const Idx* __restrict__ idx,
                  uint8_t* __restrict__ out, int64_t n_rows,
                  int64_t row_bytes) {
  const int64_t i = blockIdx.x;
  const int64_t r = clamped_row(idx, i, n_rows);
  const uint8_t* s = src + r * row_bytes;
  uint8_t* d = out + i * row_bytes;
  for (int64_t c = threadIdx.x; c < row_bytes; c += kByteThreads) {
    d[c] = s[c];
  }
}

// Cut a row (a multiple of 16 bytes) into the fewest chunks of at most
// kMaxChunk bytes, each a multiple of 16, all but the last of one size.
void chunk_plan(int64_t row_bytes, int64_t* chunk, int64_t* chunks) {
  const int64_t n = (row_bytes + kMaxChunk - 1) / kMaxChunk;
  *chunk = ((row_bytes + n - 1) / n + 15) / 16 * 16;
  *chunks = (row_bytes + *chunk - 1) / *chunk;
}

// The blocks of `kernel` the card holds at once with `smem` bytes of
// ring each: the SM count times the blocks an SM's shared memory
// allows. Above 48 KB a kernel needs an opt-in; it is always set to the
// largest ring, so no row size lowers the limit another launches with.
// Queried on the first launch of each (device, kernel, ring size) and
// cached (a few entries: two index types times the row sizes in use).
struct Geometry {
  int dev;
  const void* kernel;
  size_t smem;
  int64_t blocks;
};
constexpr int kGeometrySlots = 64;
Geometry g_geometry[kGeometrySlots];
int g_geometry_used = 0;
std::mutex g_geometry_mu;

cudaError_t resident_blocks(int dev, const void* kernel, size_t smem,
                            int64_t* blocks) {
  std::lock_guard<std::mutex> lock(g_geometry_mu);
  for (int i = 0; i < g_geometry_used; ++i) {
    const Geometry& g = g_geometry[i];
    if (g.dev == dev && g.kernel == kernel && g.smem == smem) {
      *blocks = g.blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStages * kMaxChunk);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32,
                                                        smem);
  }
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  *blocks = static_cast<int64_t>(sms) * per_sm;
  if (err == cudaSuccess && g_geometry_used < kGeometrySlots) {
    g_geometry[g_geometry_used++] = {dev, kernel, smem, *blocks};
  }
  return err;
}

template <typename Idx>
cudaError_t launch_bulk(int dev, const void* src, const void* idx, void* out,
                        int64_t n_rows, int64_t m, int64_t row_bytes,
                        cudaStream_t stream) {
  int64_t chunk = 0, chunks = 0;
  chunk_plan(row_bytes, &chunk, &chunks);
  const int64_t units = m * chunks;
  const size_t smem = static_cast<size_t>(kStages * chunk);
  const void* kernel = reinterpret_cast<const void*>(&gather_rows_bulk<Idx>);
  int64_t blocks = 0;
  const cudaError_t err = resident_blocks(dev, kernel, smem, &blocks);
  if (err != cudaSuccess) return err;
  const unsigned int grid =
      static_cast<unsigned int>(units < blocks ? units : blocks);
  gather_rows_bulk<Idx><<<grid, 32, smem, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<const Idx*>(idx),
      static_cast<uint8_t*>(out), n_rows, row_bytes, units, chunk, chunks);
  return cudaGetLastError();
}

template <typename Idx>
cudaError_t launch(int dev, const void* src, const void* idx, void* out,
                   int64_t n_rows, int64_t m, int64_t row_bytes,
                   cudaStream_t stream) {
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!vec) {
    gather_rows_bytes<Idx><<<static_cast<unsigned int>(m), kByteThreads, 0,
                             stream>>>(
        static_cast<const uint8_t*>(src), static_cast<const Idx*>(idx),
        static_cast<uint8_t*>(out), n_rows, row_bytes);
    return cudaGetLastError();
  }
  return launch_bulk<Idx>(dev, src, idx, out, n_rows, m, row_bytes,
                          stream);
}

}  // namespace

// On device `dev` (the current device, whose stream `stream` is): src
// [n_rows, row_bytes] bytes, idx [m] int32 (idx_is_64 = 0) or int64
// (idx_is_64 = 1), out [m, row_bytes] bytes. m must be in [1, 2^31 - 1]
// and n_rows >= 1 (the wrapper checks both). Returns a cudaError_t: a
// refused launch is reported to the caller.
extern "C" int gather_rows_launch(int dev, const void* src, const void* idx,
                                  int idx_is_64, void* out, int64_t n_rows,
                                  int64_t m, int64_t row_bytes,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      idx_is_64
          ? launch<int64_t>(dev, src, idx, out, n_rows, m, row_bytes, s)
          : launch<int32_t>(dev, src, idx, out, n_rows, m, row_bytes, s));
}
