// TransE's fast batch on the fused [N+R, k] table, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's fast update
// (kb2e_tpu/models/transe.py::fused_table_update) is XLA's gather,
// scatter-add and ball-norm, and the port ran it as some 20 eager torch calls
// (about 48 kernels) a batch.  One batch of the reference's double-buffered
// SGD (transe/trainer.cpp:48-56), as models/transe.py::fused_table_update
// computes it on the table T = [entity; relation]:
//   for every row i of the batch, from the batch-start table:
//     x_p = dir(t - h - r), x_n = dir(t' - h' - r);
//     if valid and e_p + margin > e_n:
//       loss += margin + e_p - e_n;
//       h += lr x_p;  t -= lr x_p;  h' -= lr x_n;  t' += lr x_n;  r += lr (x_p - x_n);
//   then every row of T ball-normed (divided by its norm where that exceeds 1);
// with e = sum |res| (L1) or sum res^2 (L2), and dir(res) = +1 where
// 2 res > 0, else -1 (L1, 0 included), or 2 res (L2).
//
// Bound on an H100: bytes, and most of them in L2.  At FB15k (16,296 rows of
// k = 100) the table and its accumulator are 6.5 MB each and stay in the
// card's 50 MB L2 from batch to batch; a batch reads its 5 rows a sample and
// adds 5 deltas a sample, then walks the whole table once.  The operations
// (about 19 a row and coordinate) are far below the bytes.  What the eager
// version paid was the host: 48 launches a batch and every [5 B, k]
// intermediate through memory.
//
// Design: three launches a batch, made by one host call, in place on the
// table T and an accumulator A [N+R, k], which equals T between batches (the
// plain version's clone, kept instead of made a batch).
//  1. transe_fast_score_kernel: one warp per group of `group` consecutive rows
//     (the caller passes K, the negatives a positive, and the sampler lays
//     out a positive's K rows side by side: a row whose positive (h, t, r) is
//     the previous row's reuses its rows, residual and energy).  A lane holds
//     4 coordinates a 16-byte chunk (k = 100 is 25 chunks).  The warp reads
//     the batch-start T, sums each energy across the warp (every lane gets
//     the same bits, so the decision is uniform), and writes the row's
//     decision and, where it steps, its two directions x_p, x_n into X
//     [rows, 2, k].  Each block adds its loss into *loss once.
//  2. transe_fast_scatter_kernel: the five deltas of every stepping row added
//     into A, one vector atomic a chunk, over a grid-stride loop in the order
//     of the plain version's index_add: the h deltas of every row, then the
//     t, h', t' and r deltas, with index_add's grid (4 coordinates a thread,
//     so a fourth of its threads) and so about as many deltas in flight.
//     Each add rounds at its row's magnitude, as index_add's do, and mostly
//     in the same order.  Under L1 a row's non-zero deltas share one
//     magnitude and round alike in any order unless the row's value crosses
//     a power of two, which small values do often; and one rounding apart
//     flips an L1 direction wherever a residual coordinate is within it of 0.
//     Added straight from launch 1, a sample's five at a time, the tables
//     parted from the plain version's in about 8 times as many elements as
//     index_add parts from itself, and such flips followed.  The loop's
//     latency, not its bytes, bounds this launch.
//  3. transe_fast_apply_kernel: one warp per row of A, every row: v =
//     ball_norm(A), stored to T where it differs from T and to A where it was
//     scaled.  A row with no delta and a norm of at most 1 is not written.
// Launch 1 reads T and launch 2 adds into A, so every read of a batch sees the
// batch-start table, as the reference's double buffer requires.  The energies
// and norms sum in the order of torch's CUDA row sum (k < 128), so they equal
// the plain version's bit for bit.  Launch 1 checks every id against its table
// and traps on one outside it.
//
// Both orders are torch's, copied and not called: launch 2 walks the deltas
// as torch 2.11's CUDA index_add does (blocks of 128 threads, the index in
// order within a role), and row_sum adds lanes as torch 2.11's CUDA row sum
// of a contiguous float32 tensor does (checked on the card for k < 128).  A
// torch whose orders differ leaves these kernels exact on dyadic tables, but
// parts their tables from fused_table_update's in more elements.  That
// matters: the benchmark's TransE change limits (1e-5) lie under what one L1
// direction flipped by one rounding reads (about 2.5e-5), so the card tests
// read those gaps over many seeds at the benchmark cells' shapes.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps a block, in both launches
constexpr int kThreads = kWarps * 32;
constexpr int kScatterThreads = 128;  // index_add's block
constexpr int kMaxK = 1024;  // 8 chunks of 4 coordinates a lane
constexpr unsigned kAll = 0xffffffffu;

struct Feed {
  const int* ph;  // [rows] each row's positive head, tail and relation,
  const int* pt;
  const int* r;   // the relation's own id (row n_entities + r of T)
  const int* nh;  // and its corrupted head and tail
  const int* nt;
  int rows, n_entities;
};

struct ScoreArgs {
  Feed f;
  const float* table;   // [n_rows, k] the batch-start table T
  const bool* valid;    // [rows]
  unsigned char* step;  // [rows] whether the row steps
  float* x;             // [rows, 2, k] x_p, x_n of the rows that step
  float* loss;          // the batch's loss, added into
  int group, k, n_relations;
  float margin;
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}

__device__ __forceinline__ float4 scale4(float s, float4 a) {
  return make_float4(__fmul_rn(s, a.x), __fmul_rn(s, a.y), __fmul_rn(s, a.z), __fmul_rn(s, a.w));
}

// Chunk c4 (coordinates 4 c4 .. 4 c4 + 3) of a row; coordinates past k read
// as 0.  kVec: k is a multiple of 4 and the table 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* row, int c4, int k) {
  if (kVec) return reinterpret_cast<const float4*>(row)[c4];
  const int c = 4 * c4;
  return make_float4(row[c], c + 1 < k ? row[c + 1] : 0.f, c + 2 < k ? row[c + 2] : 0.f,
                     c + 3 < k ? row[c + 3] : 0.f);
}

template <bool kVec>
__device__ __forceinline__ void store4(float* row, int c4, int k, float4 v) {
  if (kVec) {
    reinterpret_cast<float4*>(row)[c4] = v;
    return;
  }
  const int c = 4 * c4;
  row[c] = v.x;
  if (c + 1 < k) row[c + 1] = v.y;
  if (c + 2 < k) row[c + 2] = v.z;
  if (c + 3 < k) row[c + 3] = v.w;
}

// Adds v into chunk c4 of a row of A.
template <bool kVec>
__device__ __forceinline__ void atomic_add4(float* row, int c4, int k, float4 v) {
  if (kVec) {
    atomicAdd(reinterpret_cast<float4*>(row) + c4, v);  // one vector atomic (sm_90)
    return;
  }
  const int c = 4 * c4;
  atomicAdd(row + c, v.x);
  if (c + 1 < k) atomicAdd(row + c + 1, v.y);
  if (c + 2 < k) atomicAdd(row + c + 2, v.z);
  if (c + 3 < k) atomicAdd(row + c + 3, v.w);
}

template <bool kL1>
__device__ __forceinline__ float dir(float res) {
  const float x = __fmul_rn(2.f, res);
  return kL1 ? (x > 0.f ? 1.f : -1.f) : x;
}

template <bool kL1>
__device__ __forceinline__ float4 dir4(float4 a) {
  return make_float4(dir<kL1>(a.x), dir<kL1>(a.y), dir<kL1>(a.z), dir<kL1>(a.w));
}

__device__ __forceinline__ void check_id(int id, int n) {
  if (static_cast<unsigned>(id) >= static_cast<unsigned>(n)) __trap();
}

// The sum over a row of the per-coordinate values v (lane l's chunk j holds
// coordinates 4 (l + 32 j) .. + 3; 0 past k), the same in every lane.  For
// k < 128 (one chunk a lane) in the order of torch's CUDA row sum of a
// contiguous [M, k] float32 tensor, so that the energies and norms equal the
// plain version's bit for bit: with w = min(2^floor(log2 k), 32), lane l < w
// adds coordinates l, l + w, l + 2w, ... in turn, then lanes l and l + o are
// added for o = w/2, w/4, ..., 1.  Wider rows: each lane's chunks in turn,
// then an xor butterfly.
template <int C>
__device__ __forceinline__ float row_sum(const float4 (&v)[C], int k) {
  const int lane = threadIdx.x & 31;
  if (C == 1 && k < 128) {
    const int w = k >= 32 ? 32 : 1 << (31 - __clz(k));
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + w * i;  // the coordinate lane l adds at step i, held by lane c / 4
      const int src = (c >> 2) & 31;
      const float x = __shfl_sync(kAll, v[0].x, src), y = __shfl_sync(kAll, v[0].y, src);
      const float z = __shfl_sync(kAll, v[0].z, src), u = __shfl_sync(kAll, v[0].w, src);
      const int q = c & 3;
      const float e = q == 0 ? x : q == 1 ? y : q == 2 ? z : u;
      if (lane < w && c < k) acc = i == 0 ? e : __fadd_rn(acc, e);
    }
    for (int o = w >> 1; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_down_sync(kAll, acc, o));
    return __shfl_sync(kAll, acc, 0);
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < C; ++j) acc = __fadd_rn(acc, __fadd_rn(__fadd_rn(__fadd_rn(v[j].x, v[j].y), v[j].z), v[j].w));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(kAll, acc, o));
  return acc;
}

template <bool kL1>
__device__ __forceinline__ float4 energy_terms(float4 a) {
  return kL1 ? make_float4(fabsf(a.x), fabsf(a.y), fabsf(a.z), fabsf(a.w))
             : make_float4(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y), __fmul_rn(a.z, a.z), __fmul_rn(a.w, a.w));
}

// Launch 1: the energies, decisions and loss of a group of rows, and the
// directions of those that step.  C: chunks a lane holds (k <= 128 C).
template <int C, bool kVec, bool kL1>
__global__ void __launch_bounds__(kThreads) transe_fast_score_kernel(const ScoreArgs a) {
  __shared__ float warp_loss[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = a.k, n4 = (k + 3) >> 2;
  const Feed& f = a.f;
  const long long first = (static_cast<long long>(blockIdx.x) * kWarps + warp) * a.group;
  const long long end = first + a.group < f.rows ? first + a.group : f.rows;
  // The positive whose relation row and residual the registers hold.
  float4 rv[C], rp[C], terms[C];
  int h = -1, t = -1, r = -1;
  float e_p = 0.f, lsum = 0.f;
  for (long long i = first; i < end; ++i) {
    const int ih = f.ph[i], it = f.pt[i], ir = f.r[i], ia = f.nh[i], ib = f.nt[i];
    check_id(ih, f.n_entities);
    check_id(it, f.n_entities);
    check_id(ia, f.n_entities);
    check_id(ib, f.n_entities);
    check_id(ir, a.n_relations);
    if (ih != h || it != t || ir + f.n_entities != r) {
      h = ih;
      t = it;
      r = ir + f.n_entities;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int c4 = lane + 32 * j;
        rv[j] = rp[j] = zero4();
        if (c4 < n4) {
          rv[j] = load4<kVec>(a.table + static_cast<size_t>(r) * k, c4, k);
          rp[j] = sub4(sub4(load4<kVec>(a.table + static_cast<size_t>(t) * k, c4, k),
                            load4<kVec>(a.table + static_cast<size_t>(h) * k, c4, k)), rv[j]);
        }
        terms[j] = energy_terms<kL1>(rp[j]);
      }
      e_p = row_sum<C>(terms, k);
    }
    float4 rn[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c4 = lane + 32 * j;
      rn[j] = zero4();
      if (c4 < n4) {
        rn[j] = sub4(sub4(load4<kVec>(a.table + static_cast<size_t>(ib) * k, c4, k),
                          load4<kVec>(a.table + static_cast<size_t>(ia) * k, c4, k)), rv[j]);
      }
      terms[j] = energy_terms<kL1>(rn[j]);
    }
    const float e_n = row_sum<C>(terms, k);
    const bool steps = a.valid[i] && __fadd_rn(e_p, a.margin) > e_n;
    if (lane == 0) a.step[i] = steps;
    if (!steps) continue;
    lsum = __fadd_rn(lsum, __fsub_rn(__fadd_rn(a.margin, e_p), e_n));
    float* xi = a.x + static_cast<size_t>(i) * 2 * k;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c4 = lane + 32 * j;
      if (c4 < n4) {
        store4<kVec>(xi, c4, k, dir4<kL1>(rp[j]));
        store4<kVec>(xi + k, c4, k, dir4<kL1>(rn[j]));
      }
    }
  }
  if (lane == 0) warp_loss[warp] = lsum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, warp_loss[w]);
    if (s != 0.f) atomicAdd(a.loss, s);
  }
}

// Launch 2: chunk c4 of the deltas of the stepping rows, for every (role,
// row, chunk) of the batch in the plain version's order (role-major, as
// index_add walks cat([h, t, h', t', r])), added into A.  A unit's loads do
// not wait on one another, so a thread has one round trip to L2 in flight.
template <bool kVec>
__global__ void __launch_bounds__(kScatterThreads)
transe_fast_scatter_kernel(const Feed f, const unsigned char* __restrict__ step, const float* __restrict__ x,
                           float* acc, int k, float lr) {
  const int n4 = (k + 3) >> 2;
  const int per_role = f.rows * n4;
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < 5 * per_role; u += gridDim.x * blockDim.x) {
    const int role = u / per_role;
    const int i = (u - role * per_role) / n4;
    const int c4 = u - role * per_role - i * n4;
    const float* xi = x + static_cast<size_t>(i) * 2 * k;
    const bool steps = step[i];
    const int id = (role == 0 ? f.ph : role == 1 ? f.pt : role == 2 ? f.nh : role == 3 ? f.nt : f.r)[i];
    const float4 xa = load4<kVec>(role == 2 || role == 3 ? xi + k : xi, c4, k);
    const float4 xb = role == 4 ? load4<kVec>(xi + k, c4, k) : zero4();
    if (!steps) continue;
    // The plain version's deltas: lr x_p, -lr x_p, -lr x_n, lr x_n, lr (x_p - x_n).
    const float4 d = role == 4 ? scale4(lr, sub4(xa, xb)) : scale4(role == 1 || role == 2 ? -lr : lr, xa);
    const int row = role == 4 ? id + f.n_entities : id;
    atomic_add4<kVec>(acc + static_cast<size_t>(row) * k, c4, k, d);
  }
}

// Launch 3, one warp a row: v = ball_norm(A), written to T where it differs
// from T (where a delta landed or the norm exceeds 1), and to A where the
// norm exceeds 1.
template <int C, bool kVec>
__global__ void __launch_bounds__(kThreads) transe_fast_apply_kernel(float* table, float* acc, int n_rows, int k) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp: no barrier follows
  const int n4 = (k + 3) >> 2;
  float* t_row = table + row * k;
  float* a_row = acc + row * k;
  float4 v[C], sq[C];
  bool moved = false;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c4 = lane + 32 * j;
    v[j] = zero4();
    if (c4 < n4) {
      const float4 was = load4<kVec>(t_row, c4, k);
      v[j] = load4<kVec>(a_row, c4, k);
      moved |= v[j].x != was.x || v[j].y != was.y || v[j].z != was.z || v[j].w != was.w;
    }
    sq[j] = energy_terms<false>(v[j]);
  }
  const float nrm = __fsqrt_rn(row_sum<C>(sq, k));
  const bool scaled = nrm > 1.f;
  if (!__any_sync(kAll, moved) && !scaled) return;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c4 = lane + 32 * j;
    if (c4 < n4) {
      float4 w = v[j];
      if (scaled) w = make_float4(__fdiv_rn(w.x, nrm), __fdiv_rn(w.y, nrm), __fdiv_rn(w.z, nrm), __fdiv_rn(w.w, nrm));
      store4<kVec>(t_row, c4, k, w);
      if (scaled) store4<kVec>(a_row, c4, k, w);
    }
  }
}

// Chunks a lane holds at width k: 1, 2, 4 or 8.
int chunks_for(int k) {
  const int per_lane = ((k + 3) / 4 + 31) / 32;
  return per_lane <= 1 ? 1 : per_lane <= 2 ? 2 : per_lane <= 4 ? 4 : 8;
}

bool aligned(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

template <int C, bool kVec>
void launch_score(bool l1, int blocks, cudaStream_t s, const ScoreArgs& a) {
  if (l1) {
    transe_fast_score_kernel<C, kVec, true><<<blocks, kThreads, 0, s>>>(a);
  } else {
    transe_fast_score_kernel<C, kVec, false><<<blocks, kThreads, 0, s>>>(a);
  }
}

template <int C>
void launch_score(bool vec, bool l1, int blocks, cudaStream_t s, const ScoreArgs& a) {
  if (vec) {
    launch_score<C, true>(l1, blocks, s, a);
  } else {
    launch_score<C, false>(l1, blocks, s, a);
  }
}

template <int C>
void launch_apply(bool vec, int blocks, cudaStream_t s, float* table, float* acc, int n_rows, int k) {
  if (vec) {
    transe_fast_apply_kernel<C, true><<<blocks, kThreads, 0, s>>>(table, acc, n_rows, k);
  } else {
    transe_fast_apply_kernel<C, false><<<blocks, kThreads, 0, s>>>(table, acc, n_rows, k);
  }
}

}  // namespace

// One batch on `stream` of device `device`: launch 1 over its rows [rows],
// launch 2 over their deltas, launch 3 over the table [n_entities +
// n_relations, k].  Returns cudaGetLastError(): 0 when every launch was
// accepted.
extern "C" int kb2e_transe_fast_batch(float* table, float* acc, float* x, unsigned char* step, const int* ph,
                                      const int* pt, const int* r, const int* nh, const int* nt, const bool* valid,
                                      float* loss, int rows, int group, int k, int n_entities, int n_relations,
                                      int l1, int device, float lr, float margin, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= 0 || k > kMaxK || group <= 0 || rows < 0 || n_entities <= 0 || n_relations <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 && aligned(table) && aligned(acc) && aligned(x);
  const int c = chunks_for(k);
  if (rows > 0) {
    const Feed f{ph, pt, r, nh, nt, rows, n_entities};
    const ScoreArgs a{f, table, valid, step, x, loss, group, k, n_relations, margin};
    const long long groups = (static_cast<long long>(rows) + group - 1) / group;
    const int blocks = static_cast<int>((groups + kWarps - 1) / kWarps);
    switch (c) {
      case 1: launch_score<1>(vec, l1 != 0, blocks, s, a); break;
      case 2: launch_score<2>(vec, l1 != 0, blocks, s, a); break;
      case 4: launch_score<4>(vec, l1 != 0, blocks, s, a); break;
      default: launch_score<8>(vec, l1 != 0, blocks, s, a); break;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // index_add's grid is 8 blocks an SM of 128 threads, a coordinate each;
    // here a thread adds 4, so a fourth of that.
    const long long units = 5LL * rows * ((k + 3) / 4);
    const long long want = (units + kScatterThreads - 1) / kScatterThreads;
    const int scatter_blocks = static_cast<int>(want < 2LL * sms ? want : 2LL * sms);
    if (vec) {
      transe_fast_scatter_kernel<true><<<scatter_blocks, kScatterThreads, 0, s>>>(f, step, x, acc, k, lr);
    } else {
      transe_fast_scatter_kernel<false><<<scatter_blocks, kScatterThreads, 0, s>>>(f, step, x, acc, k, lr);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_rows = n_entities + n_relations;
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  switch (c) {
    case 1: launch_apply<1>(vec, blocks, s, table, acc, n_rows, k); break;
    case 2: launch_apply<2>(vec, blocks, s, table, acc, n_rows, k); break;
    case 4: launch_apply<4>(vec, blocks, s, table, acc, n_rows, k); break;
    default: launch_apply<8>(vec, blocks, s, table, acc, n_rows, k); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kb2e_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
