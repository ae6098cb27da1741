// Rank-count sweep for link-prediction evaluation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of kb2e_tpu/ops/pallas_rank.py::rank_counts:
// _rank_count_kernel_l1 (L1, "K1") and _rank_count_kernel_l2 (L2, "K2").
// For each query b it counts the entities j != true_b that rank before the
// true entity:  E_jb < e_true_b, or E_jb == e_true_b and j < true_b, with
//   L1: E_jb = sum_k |e_kj - q_kb|
//   L2: E_jb = max(|q_b|^2 + |e_j|^2 - 2 q_b.e_j, 0)
// and never writes the [B, N] energy matrix anywhere.
//
// Bound on an H100: compute.  Per call the work is B*N*k elements: for L1 a
// subtract and an absolute-add (two fp32 instructions, no tensor cores), for
// L2 one fp32 FMA.  The bytes are the [k, N] table (6 MB at FB15k, k = 100)
// plus the [k, B] queries, read once from device memory and then served from
// the 50 MB L2 cache to every query tile, so the FP32 pipes, not memory,
// bound the kernel.  L2's product stays in plain fp32 FMAs (no tensor cores,
// no TF32), because TF32 rounding changes ranks.
//
// Design, against the TPU kernel's sequential grid that carries a [B, TILE_N]
// accumulator from one k-chunk step to the next:
//  * a block takes 256 entities (one per thread) x 32 queries and loops over
//    all of k itself, so nothing carries over between blocks;
//  * the query tile is staged through shared memory, 32 k-rows at a time,
//    and read back as float4 broadcasts; each thread keeps its 32 partial
//    energies in registers; the table row kk is read coalesced, neighbouring
//    threads on neighbouring entities of proj_t[kk, :];
//  * the beats of a warp are reduced per query with a ballot and a popcount,
//    summed per block in shared memory, and added to out[b] with one integer
//    atomicAdd per (block, query), so the result does not depend on the
//    order in which blocks run;
//  * ragged edges are masked here: j >= N and b >= B take no part, so the
//    caller passes the real N and B and no padded rows (the 1e30 rows of the
//    TPU path would give |e|^2 = inf in L2).
// The caller zeroes out[] and computes e_true with the direct residual
// formula, and for L2 the squared norms e_sq [N] and q_sq [B].

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // entities per block, one per thread
constexpr int kQueries = 32;   // queries per block, energies in registers
constexpr int kRows = 32;      // k-rows of the query tile staged at a time

template <bool kL2>
__global__ void __launch_bounds__(kThreads)
rank_count_kernel(const float* __restrict__ proj_t,     // [k, n]
                  const float* __restrict__ queries_t,  // [k, b]
                  const float* __restrict__ e_true,     // [b]
                  const int* __restrict__ true_idx,     // [b]
                  const float* __restrict__ e_sq,       // [n], L2 only
                  const float* __restrict__ q_sq,       // [b], L2 only
                  int* __restrict__ out,                // [b], zeroed
                  int k, int n, int b) {
  __shared__ float4 q_tile[kRows][kQueries / 4];
  __shared__ float s_etrue[kQueries];
  __shared__ float s_qsq[kQueries];
  __shared__ int s_tidx[kQueries];
  __shared__ int s_count[kQueries];

  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int b0 = blockIdx.y * kQueries;
  const bool live = j < n;

  if (threadIdx.x < kQueries) {
    const int bq = b0 + threadIdx.x;
    const bool real = bq < b;
    s_etrue[threadIdx.x] = real ? e_true[bq] : 0.f;
    s_tidx[threadIdx.x] = real ? true_idx[bq] : -1;
    s_qsq[threadIdx.x] = (kL2 && real) ? q_sq[bq] : 0.f;
    s_count[threadIdx.x] = 0;
  }

  float acc[kQueries];
#pragma unroll
  for (int q = 0; q < kQueries; ++q) acc[q] = 0.f;

  float* q_flat = reinterpret_cast<float*>(q_tile);
  for (int k0 = 0; k0 < k; k0 += kRows) {
    const int rows = min(kRows, k - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kRows * kQueries; i += kThreads) {
      const int r = i / kQueries;
      const int bq = b0 + i % kQueries;
      q_flat[i] = (r < rows && bq < b) ? queries_t[(size_t)(k0 + r) * b + bq] : 0.f;
    }
    __syncthreads();
    if (live) {
      for (int r = 0; r < rows; ++r) {
        const float e = proj_t[(size_t)(k0 + r) * n + j];
#pragma unroll
        for (int q4 = 0; q4 < kQueries / 4; ++q4) {
          const float4 qv = q_tile[r][q4];
          if (kL2) {
            acc[4 * q4 + 0] = fmaf(qv.x, e, acc[4 * q4 + 0]);
            acc[4 * q4 + 1] = fmaf(qv.y, e, acc[4 * q4 + 1]);
            acc[4 * q4 + 2] = fmaf(qv.z, e, acc[4 * q4 + 2]);
            acc[4 * q4 + 3] = fmaf(qv.w, e, acc[4 * q4 + 3]);
          } else {
            acc[4 * q4 + 0] += fabsf(e - qv.x);
            acc[4 * q4 + 1] += fabsf(e - qv.y);
            acc[4 * q4 + 2] += fabsf(e - qv.z);
            acc[4 * q4 + 3] += fabsf(e - qv.w);
          }
        }
      }
    }
  }

  const float esq_j = (kL2 && live) ? e_sq[j] : 0.f;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kQueries; ++q) {
    const int tidx = s_tidx[q];
    bool beats = false;
    if (live && b0 + q < b) {
      float en = acc[q];
      if (kL2) {
        // (|q|^2 + |e|^2) - 2 q.e, rounded step by step as the plain
        // version does; the _rn intrinsics keep nvcc from fusing an FMA.
        en = fmaxf(__fsub_rn(__fadd_rn(s_qsq[q], esq_j), __fmul_rn(2.f, en)), 0.f);
      }
      const float et = s_etrue[q];
      beats = (j != tidx) && (en < et || (en == et && j < tidx));
    }
    const unsigned mask = __ballot_sync(0xffffffffu, beats);
    if (lane == 0 && mask != 0u) atomicAdd(&s_count[q], __popc(mask));
  }
  __syncthreads();
  if (threadIdx.x < kQueries && b0 + threadIdx.x < b && s_count[threadIdx.x] != 0) {
    atomicAdd(&out[b0 + threadIdx.x], s_count[threadIdx.x]);
  }
}

}  // namespace

// Launches on `stream` of device `device` and returns cudaGetLastError():
// 0 when the launch was accepted.  e_sq and q_sq may be null when l2 == 0.
extern "C" int kb2e_rank_count(const float* proj_t, const float* queries_t,
                               const float* e_true, const int* true_idx,
                               const float* e_sq, const float* q_sq, int* out,
                               int k, int n, int b, int l2, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || b <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, (b + kQueries - 1) / kQueries);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l2) {
    rank_count_kernel<true><<<grid, kThreads, 0, s>>>(
        proj_t, queries_t, e_true, true_idx, e_sq, q_sq, out, k, n, b);
  } else {
    rank_count_kernel<false><<<grid, kThreads, 0, s>>>(
        proj_t, queries_t, e_true, true_idx, e_sq, q_sq, out, k, n, b);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kb2e_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
