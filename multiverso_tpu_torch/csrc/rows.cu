// Row kernels of the parameter-server hot path, written for Hopper (sm_90a).
//
// One kernel template, rows_group_kernel<OP, unit>, replaces the three
// Pallas TPU kernels of multiverso_tpu/ops/pallas_rows.py:
//
//   rows_group_kernel<kGather>   <- pallas_gather_rows       (:170)
//   rows_group_kernel<kSet>      <- pallas_scatter_set_rows  (:244)
//   rows_group_kernel<kAdd|kSub> <- pallas_update_rows       (:362)
//
// Shared contract (the caller, multiverso_tpu_torch/tables/matrix_table.py,
// enforces it): ids are int32; every id lies in [0, rows) of the table;
// pad lanes are mapped to the table's trash row before the call; duplicate
// ids occur only on the trash row, whose content is don't-care (concurrent
// writes there are benign). An id outside [0, rows) is never dereferenced:
// its lane is skipped (nothing is written to the table for it; a gathered
// lane, and an out_rows lane of the update, is zero-filled) and the
// device-side error word gets bit 0 set. The hot path never reads the word
// back; tests and chip_smoke.py do, after a synchronise.
//
// Bounds on an H100 SXM (3.35 TB/s HBM3; no arithmetic worth counting, so
// bytes bound all three), for n ids of C float32 columns:
//   gather      2*n*C*4 + 4*n bytes        (read the rows, write the out)
//   scatter-set 2*n*C*4 + 4*n bytes        (read the rows, write the table)
//   update      3*n*C*4 + 4*n bytes        (read row + delta, write row)
//               + n*C*4 with out_rows      (write the post-update rows)
// divided by 3.35e12 B/s. Each row is a random 16-byte-aligned segment.
// At the PS shape (10,000 ids x 52 cols, 4.2 MB, bound 1.25 us) no kernel
// comes near the bound. On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, PERF.md) an empty launch takes 4.8 us timed per-pair
// (each launch between its own pair of CUDA events) and 1.8 us timed by
// stream (one event pair around 30 launches); by stream the PS gather
// takes 4.4 us, the scatter-set 5.4 us and the update 6.4 us, the rest
// being the chain id load -> row load -> store. At the WE shape (40,000
// ids x 128 cols) the kernels are bound by bytes: 75-87% of the bound by
// stream.
//
// Design (row groups). A row is moved by a group of `lanes` neighbouring
// threads, lanes the smallest power of two that covers the row's 16-byte
// units (floats when the layout is not 16-byte aligned), at most a warp;
// wider rows loop. So a 52-float row (13 float4s) takes 16 lanes and two
// rows share a warp, where one warp per row would leave 19 of its 32
// lanes idle and need twice the warps (1.2 waves at the PS shape). The
// grid is sized from the card's SM count: at most kBlocksPerSm resident
// blocks per SM (a full SM), each group walking rows grid-stride, so the
// PS shape runs as one wave and a larger batch keeps every SM full without
// a tail of queued blocks. Rows go straight from registers to their
// destination: nothing is reused, so nothing is staged in shared memory.
// The scatter-set is the gather with its sides swapped: the contiguous
// source row is read through the read-only path and stored to the table
// row with a plain store (a streaming, evict-first store measured level
// at the PS shape). Two earlier designs were measured slower at both
// shapes of the main path: one warp per row, and a ring of
// mbarrier-tracked shared-memory stages filled by bulk and 16-byte async
// copies; PERF.md keeps the numbers.
// The launch geometry (lanes, grid, whether units are float4s) comes from
// plan_rows() in ops/cuda_rows.py, the same for all three ops. Ids are
// widened to int64 before they form an offset, so tables past 2^31 floats
// address right.
//
// Plain C interface, loaded with ctypes by ops/cuda_rows.py. Every entry
// launches on the given stream, never synchronises, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a plan that does not
// match its tensors) so a refused launch is reported at the call.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {
// Launch geometry, computed by plan_rows() in ops/cuda_rows.py.
struct MvtRowPlan {
  long long lanes;      // threads per row: a power of two, 1..32
  long long grid;       // blocks of the row-group kernel
  long long vec;        // 1: rows move as float4s (C % 4 == 0, aligned)
};
}

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // 2,048 threads: a full Hopper SM

enum Op { kGather = 0, kAdd = 1, kSub = 2, kSet = 3 };

template <int OP>
__device__ __forceinline__ float combine(float row, float delta) {
  return OP == kAdd ? row + delta : row - delta;
}

template <int OP>
__device__ __forceinline__ float4 combine(float4 row, float4 delta) {
  return make_float4(combine<OP>(row.x, delta.x), combine<OP>(row.y, delta.y),
                     combine<OP>(row.z, delta.z), combine<OP>(row.w, delta.w));
}

// -- row groups: gather, scatter-set and fused update -----------------------

// Units of V (float4 or float), w units a row; 1 << shift threads a row.
// OP kGather: out[i] = data[ids[i]].
// OP kSet: data[ids[i]] = src[i].
// OP kAdd / kSub: data[ids[i]] = data[ids[i]] (+|-) src[i]; out[i] = the
// new row when out is not null.
template <int OP, typename V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    rows_group_kernel(V* __restrict__ data, const int* __restrict__ ids,
                      const V* __restrict__ src, V* __restrict__ out,
                      long long n, int w, long long rows,
                      int* __restrict__ err, int shift) {
  const int lanes = 1 << shift;
  const int sub = threadIdx.x & (lanes - 1);
  const long long per_block = kThreads >> shift;
  const long long step = static_cast<long long>(gridDim.x) * per_block;
  bool bad = false;
  for (long long i = blockIdx.x * per_block + (threadIdx.x >> shift); i < n;
       i += step) {
    const long long id = static_cast<long long>(ids[i]);
    if (id < 0 || id >= rows) {
      bad = true;
      if (out != nullptr)
        for (int c = sub; c < w; c += lanes) out[i * w + c] = V{};
      continue;
    }
    V* row = data + id * w;
    for (int c = sub; c < w; c += lanes) {
      V v;
      if (OP == kGather) {
        v = __ldg(row + c);
      } else if (OP == kSet) {
        v = __ldg(src + i * w + c);
        row[c] = v;
      } else {
        v = combine<OP>(row[c], __ldg(src + i * w + c));
        row[c] = v;
      }
      if (out != nullptr) out[i * w + c] = v;
    }
  }
  if (bad && sub == 0) atomicOr(err, 1);
}

// -- host side -----------------------------------------------------------------

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The plan matches its tensors: lanes a power of two up to a warp, a grid,
// float4 units only where every pointer and row is 16-byte aligned.
inline bool plan_ok(const MvtRowPlan* p, long long cols, bool aligned) {
  const long long l = p->lanes;
  return l >= 1 && l <= 32 && (l & (l - 1)) == 0 && p->grid >= 1 &&
         p->grid < (1LL << 31) && cols < (1LL << 31) &&
         (!p->vec || (cols % 4 == 0 && aligned));
}

inline int shift_of(long long lanes) {
  int s = 0;
  while ((1LL << s) < lanes) ++s;
  return s;
}

template <int OP>
int launch_group(float* data, const int* ids, const float* src, float* out,
                 long long n, long long cols, long long rows, int* err,
                 const MvtRowPlan* p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(p->grid));
  const int shift = shift_of(p->lanes);
  if (p->vec)
    rows_group_kernel<OP, float4><<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<float4*>(data), ids,
        reinterpret_cast<const float4*>(src), reinterpret_cast<float4*>(out),
        n, static_cast<int>(cols / 4), rows, err, shift);
  else
    rows_group_kernel<OP, float><<<grid, kThreads, 0, stream>>>(
        data, ids, src, out, n, static_cast<int>(cols), rows, err, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mvt_gather_rows(const float* data, const int* ids, float* out,
                    long long n, long long cols, long long rows, int* err,
                    const MvtRowPlan* plan, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!plan_ok(plan, cols, aligned16(data) && aligned16(out)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_group<kGather>(const_cast<float*>(data), ids, nullptr, out, n,
                               cols, rows, err, plan, stream);
}

int mvt_scatter_set_rows(float* data, const int* ids, const float* src,
                         long long n, long long cols, long long rows,
                         int* err, const MvtRowPlan* plan,
                         cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!plan_ok(plan, cols, aligned16(data) && aligned16(src)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_group<kSet>(data, ids, src, nullptr, n, cols, rows, err, plan,
                            stream);
}

int mvt_update_rows(float* data, const int* ids, const float* deltas,
                    float* out_rows, long long n, long long cols,
                    long long rows, int sign, int* err,
                    const MvtRowPlan* plan, cudaStream_t stream) {
  if (n <= 0) return 0;
  const bool aligned = aligned16(data) && aligned16(deltas) &&
                       (out_rows == nullptr || aligned16(out_rows));
  if (!plan_ok(plan, cols, aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  return sign > 0 ? launch_group<kAdd>(data, ids, deltas, out_rows, n, cols,
                                       rows, err, plan, stream)
                  : launch_group<kSub>(data, ids, deltas, out_rows, n, cols,
                                       rows, err, plan, stream);
}

}  // extern "C"
