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
// Bound on an H100: the fp32 pipe (67 TFLOP/s).  Per call the work is
// B*N*k elements: for L1 a subtract and an absolute-add (two fp32
// instructions), for L2 one FMA.  The bytes are the [k, N] table (6 MB at
// FB15k, k = 100) and the [k, B] queries, read from device memory once and
// then from the 50 MB L2 cache.  On this card an SM sub-partition issues one
// warp instruction a cycle and the fp32 pipe takes one, so every load,
// compare or index instruction costs an fp32 slot: the design keeps the
// instruction stream to FMAs and adds.
//
// Order of the sums (bit-equal to the plain version, distances.
// pairwise_energy): every (query, entity) energy lives in one thread's
// register and is summed over k in ascending order, one rounded step a row:
// L1 rounds acc + |e - q| (no multiply, nothing for nvcc to fuse), L2 one
// fmaf a row and the epilogue fmaxf((q_sq + e_sq) - 2 acc, 0) in _rn steps.
// Tiling moves which thread owns a sum, never its order.  Tensor cores stay
// out: TF32, 3xTF32 and wgmma sum a k-slice inside the MMA in their own
// order (and TF32 rounds the operands), which moves near ties; L1 has no
// tensor-core form.
//
// Design:
//  * register tile: a thread owns 8 entities x 8 queries (64 accumulators,
//    at most 128 registers).  Per k-row it reads two float4 of entities and
//    two of queries from shared memory and issues 64 FMAs (L2) or 128 adds
//    (L1);
//  * block tile: 16 x 32 threads own 128 entities x 256 queries (BlockTile
//    below), so at FB15k's eval batch each table row is read from L2 once
//    per launch (8 times with the earlier 32-query tiles);
//  * staging: both tiles come into shared memory by 16-byte cp.async in a
//    ring of kStages chunks of kChunk k-rows, so the copy of chunk c + 2
//    runs under the arithmetic on chunk c; one barrier per chunk.  16-byte
//    copies need 16-byte aligned rows: the caller passes leading dimensions
//    ld_e, ld_q that are multiples of 4 floats (the wrapper pads what is
//    not; the eval harness builds its tables padded once per group), and
//    copies past column n, b or row k are zero-filled, not read;
//  * grid: one block per tile, ((n + 127) / 128) x ((b + 255) / 256).
//    At N = 14,951 and B = 256 that is 117 blocks of 512 threads, one on
//    each of 117 of the 132 SMs: one wave, 89 % full (128-entity tiles
//    cannot do better at this N; ops/rank_count.py::plan holds the same
//    arithmetic, and the smoke reports the waves from the runtime's
//    occupancy);
//  * epilogue: each thread counts its beats per query over its entities (j
//    >= n and the true entity masked here: the caller passes the real N and
//    B and no pad rows), with one compare a pair where no masked column,
//    true entity or +inf true energy is among them; the lanes that share a
//    query add by shuffle, the block adds in shared memory, and one integer
//    atomicAdd per (block, query) goes to out[b], so the counts do not
//    depend on block order.
// What holds it back on an H100 (chip_smoke.py's timing): about 5 us a
// launch beside the rows (start, the first chunk's copies, the epilogue and
// its atomics), and each LDS.128 costs its sub-partition some five issue
// slots, so a k-row of 64 FMAs takes some 86: shared-memory operands, not
// the FMA pipe, set the rate of the 8 x 8 tile, and the register file (64K
// words an SM) bounds a bigger one.  Other block tiles (128 x 128, 64 x
// 128, 16 x 8 a thread, 480 x 64, 32-row chunks) tied or lost on the card;
// PERF.md keeps their times.
// The caller zeroes out[] and computes e_true with the direct residual
// formula, and for L2 the squared norms e_sq [N] and q_sq [B].

#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstddef>

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  // A dead copy reads nothing (source size 0) and zero-fills its 16 bytes.
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// A block tile: kTX x kTY threads, each owning kPE entities x kPQ queries
// (runs of 4 consecutive columns, kTX resp. kTY float4s apart); a warp is
// kWX threads along the entities by 32 / kWX along the queries.
template <int kTX, int kTY, int kPE, int kPQ, int kWX, int kChunkRows, int kStageCount>
struct Tile {
  static constexpr int kThreads = kTX * kTY;
  static constexpr int kE = kPE, kQ = kPQ, kLanesE = kWX, kLanesQ = 32 / kWX;
  static constexpr int kThreadsE = kTX, kThreadsQ = kTY;
  static constexpr int kChunk = kChunkRows;   // k-rows a stage of the ring holds
  static constexpr int kStages = kStageCount;  // stages of the ring
  static constexpr int kN = kPE * kTX;  // entities of a block
  static constexpr int kB = kPQ * kTY;  // queries of a block
  static constexpr int kRowE = kN / 4;  // float4s of a k-row of the entity tile
  static constexpr int kRowQ = kB / 4;
  static constexpr int kStageF4 = kChunk * (kRowE + kRowQ);
  static constexpr size_t kSmemBytes = sizeof(float4) * kStages * kStageF4;
  // At most 128 registers a thread for 64 accumulators, 255 for more.
  static constexpr int kMinBlocks = 65536 / (kThreads * (kPE * kPQ > 64 ? 256 : 128));
  static_assert(kPE % 4 == 0 && kPQ % 4 == 0, "runs of 4 columns");
  static_assert(kStageCount >= 2, "a stage in flight beside the one in use");
  static_assert(kTX % kLanesE == 0 && kTY % kLanesQ == 0, "whole warps");
};

// One k-chunk's copies into stage `stage` of the ring.
template <class T>
__device__ __forceinline__ void load_chunk(float4* ring, int stage, int c, const float* __restrict__ proj_t,
                                           int ld_e, const float* __restrict__ queries_t, int ld_q, int k, int n,
                                           int b, int j0, int b0) {
  float4* dst_e = ring + stage * T::kStageF4;
  float4* dst_q = dst_e + T::kChunk * T::kRowE;
  const int k0 = c * T::kChunk;
#pragma unroll
  for (int it = 0; it < (T::kChunk * T::kRowE + T::kThreads - 1) / T::kThreads; ++it) {
    const int i = threadIdx.x + it * T::kThreads;
    if ((T::kChunk * T::kRowE) % T::kThreads != 0 && i >= T::kChunk * T::kRowE) break;
    const int r = i / T::kRowE, col = j0 + 4 * (i % T::kRowE);
    const bool live = k0 + r < k && col < n;
    cp_async16(dst_e + i, live ? proj_t + static_cast<size_t>(k0 + r) * ld_e + col : proj_t, live);
  }
#pragma unroll
  for (int it = 0; it < (T::kChunk * T::kRowQ + T::kThreads - 1) / T::kThreads; ++it) {
    const int i = threadIdx.x + it * T::kThreads;
    if ((T::kChunk * T::kRowQ) % T::kThreads != 0 && i >= T::kChunk * T::kRowQ) break;
    const int r = i / T::kRowQ, col = b0 + 4 * (i % T::kRowQ);
    const bool live = k0 + r < k && col < b;
    cp_async16(dst_q + i, live ? queries_t + static_cast<size_t>(k0 + r) * ld_q + col : queries_t, live);
  }
}

// One k-row: acc[i][q] over the thread's entities i and queries q, in the
// plain version's rounding (see the header).
template <bool kL2, class T>
__device__ __forceinline__ void row_step(float (&acc)[T::kE][T::kQ], const float4* __restrict__ row_e,
                                         const float4* __restrict__ row_q, int tx, int ty) {
  float e[T::kE], q[T::kQ];
#pragma unroll
  for (int g = 0; g < T::kE / 4; ++g) {
    const float4 v = row_e[g * T::kThreadsE + tx];
    e[4 * g] = v.x, e[4 * g + 1] = v.y, e[4 * g + 2] = v.z, e[4 * g + 3] = v.w;
  }
#pragma unroll
  for (int g = 0; g < T::kQ / 4; ++g) {
    const float4 v = row_q[g * T::kThreadsQ + ty];
    q[4 * g] = v.x, q[4 * g + 1] = v.y, q[4 * g + 2] = v.z, q[4 * g + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < T::kE; ++i) {
#pragma unroll
    for (int jq = 0; jq < T::kQ; ++jq) {
      if (kL2) {
        acc[i][jq] = fmaf(q[jq], e[i], acc[i][jq]);
      } else {
        acc[i][jq] += fabsf(e[i] - q[jq]);
      }
    }
  }
}

template <bool kL2, class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
rank_count_kernel(const float* __restrict__ proj_t,     // [k, ld_e], columns < n used
                  const float* __restrict__ queries_t,  // [k, ld_q], columns < b used
                  const float* __restrict__ e_true,     // [b]
                  const int* __restrict__ true_idx,     // [b]
                  const float* __restrict__ e_sq,       // [n], L2 only
                  const float* __restrict__ q_sq,       // [b], L2 only
                  int* __restrict__ out,                // [b], zeroed
                  int k, int n, int b, int ld_e, int ld_q) {
  constexpr int kChunk = T::kChunk, kStages = T::kStages;
  extern __shared__ float4 ring[];  // kStages x (entity chunk, query chunk)
  __shared__ float s_esq[T::kN];
  __shared__ float s_qsq[T::kB];
  __shared__ float s_etrue[T::kB];
  __shared__ int s_tidx[T::kB];
  __shared__ int s_count[T::kB];

  constexpr int kWarpsE = T::kThreadsE / T::kLanesE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = (warp % kWarpsE) * T::kLanesE + lane % T::kLanesE;  // along the entities
  const int ty = (warp / kWarpsE) * T::kLanesQ + lane / T::kLanesE;  // along the queries
  const int j0 = blockIdx.x * T::kN, b0 = blockIdx.y * T::kB;
  const int n_chunks = (k + kChunk - 1) / kChunk;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_chunk<T>(ring, s, s, proj_t, ld_e, queries_t, ld_q, k, n, b, j0, b0);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < T::kB; i += T::kThreads) {
    const bool real = b0 + i < b;
    s_etrue[i] = real ? e_true[b0 + i] : 0.f;
    s_tidx[i] = real ? true_idx[b0 + i] : -1;
    s_qsq[i] = (kL2 && real) ? q_sq[b0 + i] : 0.f;
    s_count[i] = 0;
  }
  for (int i = threadIdx.x; i < T::kN; i += T::kThreads) {
    s_esq[i] = (kL2 && j0 + i < n) ? e_sq[j0 + i] : 0.f;
  }

  float acc[T::kE][T::kQ];
#pragma unroll
  for (int i = 0; i < T::kE; ++i) {
#pragma unroll
    for (int jq = 0; jq < T::kQ; ++jq) acc[i][jq] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();               // everyone's have, and chunk c - 1 is consumed
    if (c + kStages - 1 < n_chunks) {
      load_chunk<T>(ring, (c + kStages - 1) % kStages, c + kStages - 1, proj_t, ld_e, queries_t, ld_q, k, n, b, j0,
                    b0);
    }
    cp_async_commit();
    const float4* row_e = ring + (c % kStages) * T::kStageF4;
    const float4* row_q = row_e + kChunk * T::kRowE;
    const int rows = min(kChunk, k - c * kChunk);
    if (rows == kChunk) {
#pragma unroll
      for (int r = 0; r < kChunk; ++r) row_step<kL2, T>(acc, row_e + r * T::kRowE, row_q + r * T::kRowQ, tx, ty);
    } else {
      for (int r = 0; r < rows; ++r) row_step<kL2, T>(acc, row_e + r * T::kRowE, row_q + r * T::kRowQ, tx, ty);
    }
  }
  __syncthreads();  // the side arrays are visible (also when k == 0)

  // Entity i of the thread is column 4 (g kTX + tx) + i % 4 of the tile, with
  // g = i / 4; query jq likewise with kTY and ty.
  int j[T::kE];
  float esq[T::kE];
#pragma unroll
  for (int i = 0; i < T::kE; ++i) {
    const int col = 4 * ((i / 4) * T::kThreadsE + tx) + i % 4;
    j[i] = j0 + col;
    esq[i] = s_esq[col];
  }
  const bool all_live = j0 + T::kN <= n;  // block-uniform: no column past n
#pragma unroll
  for (int jq = 0; jq < T::kQ; ++jq) {
    const int qc = 4 * ((jq / 4) * T::kThreadsQ + ty) + jq % 4;
    const float et = s_etrue[qc], qsq = s_qsq[qc];
    const int tidx = s_tidx[qc];
    float en[T::kE];
#pragma unroll
    for (int i = 0; i < T::kE; ++i) {
      // (|q|^2 + |e|^2) - 2 q.e, rounded step by step as the plain version
      // does; the _rn intrinsics keep nvcc from fusing an FMA.
      en[i] = kL2 ? fmaxf(__fsub_rn(__fadd_rn(qsq, esq[i]), __fmul_rn(2.f, acc[i][jq])), 0.f) : acc[i][jq];
    }
    // Where every entity is live, the true one is none of them and e_true is
    // not +inf, a tie counts exactly where j < true: each run of 4 compares
    // against one threshold, e_true or the next float up.
    bool common = all_live && et != CUDART_INF_F;
#pragma unroll
    for (int g = 0; g < T::kE / 4; ++g) common = common && (tidx < j[4 * g] || tidx > j[4 * g + 3]);
    int count = 0;
    if (common) {
      const float up = nextafterf(et, CUDART_INF_F);
#pragma unroll
      for (int g = 0; g < T::kE / 4; ++g) {
        const float thr = tidx > j[4 * g] ? up : et;
#pragma unroll
        for (int i = 4 * g; i < 4 * g + 4; ++i) count += en[i] < thr;
      }
    } else {
#pragma unroll
      for (int i = 0; i < T::kE; ++i) {
        count += (j[i] < n) & (j[i] != tidx) & ((en[i] < et) | ((en[i] == et) & (j[i] < tidx)));
      }
    }
    // The lanes of a warp that share this query differ in the low lane bits.
#pragma unroll
    for (int m = 1; m < T::kLanesE; m *= 2) count += __shfl_xor_sync(0xffffffffu, count, m);
    if (lane % T::kLanesE == 0 && count != 0) atomicAdd(&s_count[qc], count);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T::kB; i += T::kThreads) {
    if (b0 + i < b && s_count[i] != 0) atomicAdd(&out[b0 + i], s_count[i]);
  }
}

// The block tile (ops/rank_count.py::TILE): 16 x 32 threads, each owning 8
// entities x 8 queries, 8 lanes of a warp along the entities, a ring of 3
// chunks of 16 k-rows.  128 entities x 256 queries a block.
using BlockTile = Tile<16, 32, 8, 8, 8, 16, 3>;

constexpr int kMaxDevices = 64;

// Above 48 KB a block's dynamic shared memory needs the opt-in, once per
// template and device (the current one).
template <bool kL2>
cudaError_t prepare(int device) {
  static std::atomic<bool> ready[kMaxDevices];
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && ready[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(rank_count_kernel<kL2, BlockTile>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(BlockTile::kSmemBytes));
  if (err == cudaSuccess && cached) ready[device].store(true, std::memory_order_release);
  return err;
}

template <bool kL2>
cudaError_t launch(const float* proj_t, const float* queries_t, const float* e_true, const int* true_idx,
                   const float* e_sq, const float* q_sq, int* out, int k, int n, int b, int ld_e, int ld_q,
                   int device, cudaStream_t stream) {
  using T = BlockTile;
  const cudaError_t err = prepare<kL2>(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + T::kN - 1) / T::kN, (b + T::kB - 1) / T::kB);
  rank_count_kernel<kL2, T><<<grid, T::kThreads, T::kSmemBytes, stream>>>(proj_t, queries_t, e_true, true_idx, e_sq,
                                                                          q_sq, out, k, n, b, ld_e, ld_q);
  return cudaGetLastError();
}

template <bool kL2>
cudaError_t blocks_per_sm(int device, int* per_sm) {
  const cudaError_t err = prepare<kL2>(device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, rank_count_kernel<kL2, BlockTile>,
                                                       BlockTile::kThreads, BlockTile::kSmemBytes);
}

}  // namespace

// Launches on `stream` of device `device` and returns the CUDA error code:
// 0 when the launch was accepted.  e_sq and q_sq may be null when l2 == 0.
// ld_e and ld_q are multiples of 4, proj_t and queries_t 16-byte aligned.
extern "C" int kb2e_rank_count(const float* proj_t, const float* queries_t, const float* e_true,
                               const int* true_idx, const float* e_sq, const float* q_sq, int* out, int k, int n,
                               int b, int ld_e, int ld_q, int l2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || b <= 0) return 0;
  if (ld_e % 4 != 0 || ld_q % 4 != 0 || ld_e < n || ld_q < b) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = l2 ? launch<true>(proj_t, queries_t, e_true, true_idx, e_sq, q_sq, out, k, n, b, ld_e, ld_q, device, s)
           : launch<false>(proj_t, queries_t, e_true, true_idx, e_sq, q_sq, out, k, n, b, ld_e, ld_q, device, s);
  return static_cast<int>(err);
}

// Blocks of the L2 (or L1) kernel resident on one SM, into *per_sm.
extern "C" int kb2e_rank_count_blocks_per_sm(int l2, int device, int* per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = l2 ? blocks_per_sm<true>(device, per_sm) : blocks_per_sm<false>(device, per_sm);
  return static_cast<int>(err);
}

extern "C" const char* kb2e_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
