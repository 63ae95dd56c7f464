// Row kernels of the parameter-server hot path, written for Hopper (sm_90a).
//
// Three kernels replace the three Pallas TPU kernels of
// multiverso_tpu/ops/pallas_rows.py:
//
//   gather_rows_kernel      <- pallas_gather_rows       (_make_gather_kernel)
//   scatter_set_rows_kernel <- pallas_scatter_set_rows  (_make_scatter_kernel)
//   update_rows_kernel      <- pallas_update_rows       (_make_update_kernel)
//
// Shared contract (the caller, multiverso_tpu_torch/tables/matrix_table.py,
// enforces it): ids are int32; every id lies in [0, rows) of the table;
// pad lanes are mapped to the table's trash row before the call; duplicate
// ids occur only on the trash row, whose content is don't-care. An id
// outside [0, rows) is never dereferenced: its lane is skipped (a gathered
// lane is zero-filled) and the device-side error word gets bit 0 set. The
// hot path never reads the word back; tests and chip_smoke.py do, after a
// synchronise.
//
// Design. The Pallas kernels issue one row DMA per id in chunks of 64 ids,
// with a coalesced branch for strictly consecutive chunks, because a TPU
// core pays a fixed cost per DMA descriptor. On Hopper there are no
// descriptors to amortize: one warp moves one row, neighbouring lanes on
// neighbouring addresses, and the card keeps enough warps in flight (grid-
// stride over the ids, 8 warps per block) to cover memory latency. A run
// of consecutive ids therefore needs no branch of its own: its rows are
// already read as contiguous 128-byte segments. Lanes move 16-byte float4s
// when the row width is a multiple of 4 floats and every row pointer is
// 16-byte aligned (the table pads its storage columns to a multiple of 4
// for this), scalars otherwise. Each id is widened to int64 before it
// forms an offset, so tables past 2^31 floats address correctly.
//
// Bounds on an H100 SXM (3.35 TB/s HBM3; each kernel does no arithmetic
// worth counting, so bytes bound all three), for n ids of C float32 columns:
//   gather      2*n*C*4 + 4*n bytes        (read the rows, write the out)
//   scatter-set 2*n*C*4 + 4*n bytes        (read the rows, write the table)
//   update      3*n*C*4 + 4*n bytes        (read row + delta, write row)
//               + n*C*4 with out_rows      (write the post-update rows)
// divided by 3.35e12 B/s. What the design does about the bound: every byte
// is touched once, in full 16-byte transactions where the layout allows,
// the fused update reads each row once for both the update and the Get
// half of an Add+Get round, and nothing is staged through shared memory
// (there is no reuse to exploit). What it does not do yet: sort or cluster
// random ids for DRAM page locality, or overlap small launches.
//
// Plain C interface, loaded with ctypes by ops/cuda_rows.py. Every entry
// launches on the given stream, never synchronises, and returns
// cudaGetLastError() so a refused launch is reported at the call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
// 132 SMs x 32 blocks: enough resident and queued warps for any n, with
// the grid-stride loop covering the rest.
constexpr long long kMaxBlocks = 132LL * 32;

__device__ __forceinline__ long long warp_index() {
  return (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
}

__device__ __forceinline__ long long warp_count() {
  return (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
}

__device__ __forceinline__ void flag_bad_id(int lane, int* err) {
  if (lane == 0) atomicOr(err, 1);
}

// out[i] = data[ids[i]]
template <bool VEC>
__global__ void gather_rows_kernel(const float* __restrict__ data,
                                   const int* __restrict__ ids,
                                   float* __restrict__ out, long long n,
                                   long long cols, long long rows,
                                   int* __restrict__ err) {
  const int lane = threadIdx.x & 31;
  const long long step = warp_count();
  for (long long i = warp_index(); i < n; i += step) {
    const long long id = static_cast<long long>(ids[i]);
    float* dst = out + i * cols;
    if (id < 0 || id >= rows) {
      flag_bad_id(lane, err);
      for (long long c = lane; c < cols; c += 32) dst[c] = 0.0f;
      continue;
    }
    const float* src = data + id * cols;
    if (VEC) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      const long long c4 = cols >> 2;
      for (long long c = lane; c < c4; c += 32) d4[c] = __ldg(s4 + c);
    } else {
      for (long long c = lane; c < cols; c += 32) dst[c] = __ldg(src + c);
    }
  }
}

// data[ids[i]] = src[i]
template <bool VEC>
__global__ void scatter_set_rows_kernel(float* __restrict__ data,
                                        const int* __restrict__ ids,
                                        const float* __restrict__ src,
                                        long long n, long long cols,
                                        long long rows,
                                        int* __restrict__ err) {
  const int lane = threadIdx.x & 31;
  const long long step = warp_count();
  for (long long i = warp_index(); i < n; i += step) {
    const long long id = static_cast<long long>(ids[i]);
    if (id < 0 || id >= rows) {
      flag_bad_id(lane, err);
      continue;
    }
    const float* s = src + i * cols;
    float* dst = data + id * cols;
    if (VEC) {
      const float4* s4 = reinterpret_cast<const float4*>(s);
      float4* d4 = reinterpret_cast<float4*>(dst);
      const long long c4 = cols >> 2;
      for (long long c = lane; c < c4; c += 32) d4[c] = __ldg(s4 + c);
    } else {
      for (long long c = lane; c < cols; c += 32) dst[c] = __ldg(s + c);
    }
  }
}

template <int SIGN>
__device__ __forceinline__ float combine(float row, float delta) {
  return SIGN > 0 ? row + delta : row - delta;
}

// data[ids[i]] = data[ids[i]] (+|-) deltas[i]; out_rows[i] = the new row
// when out_rows is not null. SIGN is +1 for the add updater, -1 for sgd.
template <int SIGN, bool VEC>
__global__ void update_rows_kernel(float* __restrict__ data,
                                   const int* __restrict__ ids,
                                   const float* __restrict__ deltas,
                                   float* __restrict__ out_rows, long long n,
                                   long long cols, long long rows,
                                   int* __restrict__ err) {
  const int lane = threadIdx.x & 31;
  const long long step = warp_count();
  for (long long i = warp_index(); i < n; i += step) {
    const long long id = static_cast<long long>(ids[i]);
    float* out = out_rows ? out_rows + i * cols : nullptr;
    if (id < 0 || id >= rows) {
      flag_bad_id(lane, err);
      if (out)
        for (long long c = lane; c < cols; c += 32) out[c] = 0.0f;
      continue;
    }
    float* row = data + id * cols;
    const float* d = deltas + i * cols;
    if (VEC) {
      float4* r4 = reinterpret_cast<float4*>(row);
      const float4* d4 = reinterpret_cast<const float4*>(d);
      float4* o4 = reinterpret_cast<float4*>(out);
      const long long c4 = cols >> 2;
      for (long long c = lane; c < c4; c += 32) {
        float4 r = r4[c];
        const float4 v = __ldg(d4 + c);
        r.x = combine<SIGN>(r.x, v.x);
        r.y = combine<SIGN>(r.y, v.y);
        r.z = combine<SIGN>(r.z, v.z);
        r.w = combine<SIGN>(r.w, v.w);
        r4[c] = r;
        if (o4) o4[c] = r;
      }
    } else {
      for (long long c = lane; c < cols; c += 32) {
        const float r = combine<SIGN>(row[c], __ldg(d + c));
        row[c] = r;
        if (out) out[c] = r;
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline dim3 grid_for(long long n) {
  long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return dim3(static_cast<unsigned>(blocks));
}

}  // namespace

extern "C" {

int mvt_gather_rows(const float* data, const int* ids, float* out,
                    long long n, long long cols, long long rows, int* err,
                    cudaStream_t stream) {
  if (n <= 0) return 0;
  const bool vec = cols % 4 == 0 && aligned16(data) && aligned16(out);
  if (vec)
    gather_rows_kernel<true><<<grid_for(n), kThreads, 0, stream>>>(
        data, ids, out, n, cols, rows, err);
  else
    gather_rows_kernel<false><<<grid_for(n), kThreads, 0, stream>>>(
        data, ids, out, n, cols, rows, err);
  return static_cast<int>(cudaGetLastError());
}

int mvt_scatter_set_rows(float* data, const int* ids, const float* src,
                         long long n, long long cols, long long rows,
                         int* err, cudaStream_t stream) {
  if (n <= 0) return 0;
  const bool vec = cols % 4 == 0 && aligned16(data) && aligned16(src);
  if (vec)
    scatter_set_rows_kernel<true><<<grid_for(n), kThreads, 0, stream>>>(
        data, ids, src, n, cols, rows, err);
  else
    scatter_set_rows_kernel<false><<<grid_for(n), kThreads, 0, stream>>>(
        data, ids, src, n, cols, rows, err);
  return static_cast<int>(cudaGetLastError());
}

int mvt_update_rows(float* data, const int* ids, const float* deltas,
                    float* out_rows, long long n, long long cols,
                    long long rows, int sign, int* err, cudaStream_t stream) {
  if (n <= 0) return 0;
  const bool vec = cols % 4 == 0 && aligned16(data) && aligned16(deltas) &&
                   (out_rows == nullptr || aligned16(out_rows));
  const dim3 grid = grid_for(n);
  if (sign > 0) {
    if (vec)
      update_rows_kernel<1, true><<<grid, kThreads, 0, stream>>>(
          data, ids, deltas, out_rows, n, cols, rows, err);
    else
      update_rows_kernel<1, false><<<grid, kThreads, 0, stream>>>(
          data, ids, deltas, out_rows, n, cols, rows, err);
  } else {
    if (vec)
      update_rows_kernel<-1, true><<<grid, kThreads, 0, stream>>>(
          data, ids, deltas, out_rows, n, cols, rows, err);
    else
      update_rows_kernel<-1, false><<<grid, kThreads, 0, stream>>>(
          data, ids, deltas, out_rows, n, cols, rows, err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
