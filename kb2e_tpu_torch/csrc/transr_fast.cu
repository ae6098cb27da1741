// TransR's fast chunk, in place on the fused [N+R, k] table and W, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's fast update
// (kb2e_tpu/models/transr.py::batch_update) is XLA ops, and the port ran its
// chunk (models/transr.py::TransR.chunk_update_) as some 100 small torch
// kernels, replayed as one CUDA graph.  One chunk of B samples, as
// chunk_update_ computes it on T = [entity; relation] and W = proj [R, k, k]
// (laid out [input j, output i], so a row projects as e·W):
//  1. from the chunk-start tables, for every sample: the residuals
//     res+ = t·W − h·W − r and res− = t'·W − h'·W − r, the energies
//     e = sum |res| (L1) or sum res² (L2), viol = valid and e+ + margin > e−,
//     loss += margin + e+ − e− where viol, and the directions
//     x = dir(res) (L1: +1 where 2 res > 0, else −1; L2: 2 res);
//  2. for every violating sample: W += lr (outer(h − t, x+) − outer(h' − t', x−)),
//     h += lr W x+, t −= lr W x+, h' −= lr W x−, t' += lr W x−,
//     r += lr (x+ − x−); duplicates add up;
//  3. every row the chunk touches sphere-normed once (its entities, its
//     relations and each row of each touched W_r), pad slots and samples
//     that do not violate included;
//  4. one masked step of the ‖a·W‖ <= 1 descent on the pairs (h, W_r),
//     (t, W_r), (c, W_r) and (r, W_r) of every violating sample, c the
//     corrupted entity (h' unless h' == h, then t'), against the tables of
//     3: p = a·W, tmp = 2 p where ‖p‖² > 1 (else 0),
//     ΔW = −lr sum_s outer(a_s, tmp_s) added into W_r, and
//     a += (a − lr (W + ΔW) tmp) − a, W + ΔW being the sample's own.
//
// Bound on an H100: neither bytes nor operations.  At FB15k (k = 50, chunks
// of 256) a chunk reads about 2 MB of tables, most of it the W_r of its
// distinct relations (10 KB each, in the card's 50 MB L2 from chunk to
// chunk), and makes about 13 M operations; both take a microsecond or two on
// the card (portbench/reference/transr.py::update_work: 1.16 µs).  What
// bounds it is that each stage must see the whole chunk's previous stage, so
// a chunk is a few dependent grid-wide steps, each some microseconds of
// latency.  The replayed graph made 101 such steps, one kernel each, and a
// kernel launch costs the host about 6 µs (measured beside an H100).
//
// Design: one cooperative kernel runs a run of chunks (every block that fits
// on the card at once), four phases a chunk with a grid-wide barrier after
// each; a phase's items go to the blocks in turn:
//  1. score, a block per sample: W_r and the five rows into shared memory,
//     the four projections, the residuals, energies and decision.  Every
//     sample claims its entity rows (atomicMin of its slot into ``owner``);
//     a violating sample keeps its steps' factors (x+, x−, h − t, h' − t',
//     W x+, W x−), marks its slots in its rows' masks and itself in its
//     relation's, and lists itself among the violators.  The first sample
//     of each relation lists itself among the firsts.
//  2. steps and norms: each claimed row's owner (its lowest slot) adds the
//     steps of its marked slots one after another in slot order, sphere-norms
//     the row and stores it; a block per relation does the same for W_r
//     (ΔW of each of its samples formed again from the kept factors, each
//     element on its own) and row r.
//  3. ball step, a block per violating sample: the post-norm W_r and its four
//     pair rows, p, the decisions, W_r + ΔW in shared memory; the sample
//     keeps a, tmp and each stepping pair's delta, and each stepping pair
//     claims and marks its row.
//  4. ball adds: each claimed row's owner and each stepped relation's W_r
//     add the deltas, again one after another in slot order.
// Every read of a phase sees the tables as the phase before left them: a
// phase writes only rows it owns, and scratch.  Adding a row's steps one
// by one in slot order, as index_add's atomics mostly land, keeps the
// tables within rounding of chunk_update_'s where a row takes several.
//
// Arithmetic: every operation of chunk_update_, in float32, rounded as it
// rounds: no fused multiply-add where torch multiplies and adds apart, IEEE
// sqrt and division in the norms.  The row sums (energies, norms, ‖p‖²)
// add in the order of torch 2.11's CUDA row sum of a contiguous float32
// tensor (checked on the card for k = 33, 50 and 100: one lane adds
// coordinates l, l + 32, ... in turn, then lanes l and l + o for
// o = 16, 8, ..., 1).  Each dot product adds its terms with fused
// multiply-adds in the order cuBLAS's kernel for chunk_update_'s product
// adds them at chunks of 256 on an H100, where it was probed (Order
// below; at k = 50: two ascending halves for a row times W and W x, 16
// strided chains for (W + ΔW)·tmp, one ascending chain for ΔW's sum over the
// pairs), and in ascending order elsewhere.  This matters: ‖p‖² of a fresh
// pair lies within an ulp of 1 about once a chunk early in training, and a
// descent step decided the other way moves the change of a table by about
// what the benchmark's check allows.  A row adds its steps in slot order,
// where index_add adds them in the order its atomics land (mostly slot
// order): on dyadic tables, where every such sum is exact, the two agree
// bit for bit.
// Phase 1 checks every id against its table and traps on one outside it.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 128;  // 4 coordinates a lane
constexpr int kMaxRows = 512;  // samples a chunk: phase 1 stages their relations in shared memory
constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBatch = 16;  // samples whose steps a W_r item stages in shared memory at a time
constexpr unsigned kAll = 0xffffffffu;

struct Chunk {
  const int* ph;  // [rows] each sample's positive head, tail and relation,
  const int* pt;
  const int* r;
  const int* nh;  // its corrupted head and tail,
  const int* nt;
  const bool* valid;  // and whether it counts
  int rows, n_entities, n_relations, k;
};

// What the phases leave for the next ones.  Each violating sample keeps its
// steps, each touched row the slots that step it (``row_masks``) and its
// owner, its lowest slot in the phase (``owner``; INT_MAX between phases),
// and each relation, by its first sample, the samples that step its W_r
// (``w_masks``).  The owners clear the masks and claims they read.
struct Scratch {
  unsigned char* viol;  // [rows] the sample violates the margin
  float* loss;          // [rows] its term of the loss (0 unless it violates)
  float* step;          // [rows, 6, k] x+, x−, h − t, h' − t', W x+, W x− (violating samples)
  int* first_of;        // [rows] the first sample of the sample's relation
  int* firsts;          // [rows, 2] the first samples of the chunk's relations and their relations, in no order
  int* violators;       // [rows, 5] the violating samples and their rows h, t, c and r, in no order
  int* counts;          // [2, 2] the numbers of firsts and violators, of even and of odd chunks
  unsigned char* act;   // [rows, 4] the pair steps (‖p‖² > 1; violating samples)
  float* ball;          // [rows, 3, 4, k] a, tmp and the row delta of each pair (violating samples)
  unsigned* w_masks;    // [2, rows, sample_words(rows)] by first sample: its relation's violating, stepping samples
  unsigned* row_masks;  // [n_entities + n_relations, slot_words(rows)] by row: the slots that step it
  int* owner;           // [n_entities + n_relations]
};

// 32-bit words of a mask over a chunk's samples, and over its 4 rows slots.
__host__ __device__ __forceinline__ int sample_words(int rows) { return (rows + 31) / 32; }
__host__ __device__ __forceinline__ int slot_words(int rows) { return (4 * rows + 31) / 32; }

__device__ __forceinline__ void check_id(int id, int n) {
  if (static_cast<unsigned>(id) >= static_cast<unsigned>(n)) __trap();
}

// Shared-memory row stride of W_r in phases 1 and 3: odd, so that threads
// reading down a column hit distinct banks.
__host__ __device__ __forceinline__ int stride_of(int k) { return k | 1; }

// The sum over a row of v (lane l holds coordinates l + 32 m, 0 past k), in
// the order of torch's CUDA row sum: with w = min(2^floor(log2 k), 32), lane
// l < w adds coordinates l, l + w, l + 2w, ... in turn, then lanes l and
// l + o are added for o = w/2, ..., 1.  The same in every lane.
__device__ __forceinline__ float row_sum(const float (&v)[4], int k) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  int w = 32;
  if (k >= 32) {
    acc = v[0];
#pragma unroll
    for (int m = 1; m < 4; ++m) {
      if (lane + 32 * m < k) acc = __fadd_rn(acc, v[m]);
    }
  } else {
    w = 1 << (31 - __clz(k));
    const float other = __shfl_down_sync(kAll, v[0], w);  // coordinate l + w
    if (lane < w) acc = lane + w < k ? __fadd_rn(v[0], other) : v[0];
  }
  for (int o = w >> 1; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_down_sync(kAll, acc, o));
  return __shfl_sync(kAll, acc, 0);
}

// v / ‖v‖, as projections.sphere_norm: the squares summed as torch sums
// them, an IEEE root and IEEE divisions (each a subroutine of some hundred
// cycles, so only the lanes' coordinates are divided).
__device__ __forceinline__ void sphere_norm(float (&v)[4], int k) {
  const int lane = threadIdx.x & 31;
  float sq[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) sq[m] = __fmul_rn(v[m], v[m]);
  const float nrm = __fsqrt_rn(row_sum(sq, k));
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (lane + 32 * m < k) v[m] = __fdiv_rn(v[m], nrm);
  }
}

__device__ __forceinline__ void load_row(float (&v)[4], const float* row, int k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < 4; ++m) v[m] = lane + 32 * m < k ? row[lane + 32 * m] : 0.f;
}

__device__ __forceinline__ void store_row(float* row, const float (&v)[4], int k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (lane + 32 * m < k) row[lane + 32 * m] = v[m];
  }
}

template <bool kL1>
__device__ __forceinline__ float dir(float res) {
  const float x = __fmul_rn(2.f, res);
  return kL1 ? (x > 0.f ? 1.f : -1.f) : x;
}

// dst[q] = *src(q) for q < n, the block's threads together, as
// asynchronous copies into shared memory: a thread issues all of its copies
// before any lands.  copy_wait() waits for the thread's copies; a barrier
// then makes everyone's visible.
template <typename T, typename F>
__device__ __forceinline__ void copy_async(T* dst, int n, F src) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  for (int q = threadIdx.x; q < n; q += blockDim.x) __pipeline_memcpy_async(dst + q, src(q), 4);
}

__device__ __forceinline__ void copy_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// n_rows rows of k from src (row-major) into shared memory dst, row stride
// ds, as asynchronous copies: 16 bytes at a time where both sides allow.
__device__ __forceinline__ void load_rows(float* dst, int ds, const float* src, int n_rows, int k) {
  const int n = n_rows * k;
  if (ds == k && (n & 3) == 0 && ((reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst)) & 15) == 0) {
    for (int q = threadIdx.x; q < n >> 2; q += blockDim.x) __pipeline_memcpy_async(dst + 4 * q, src + 4 * q, 16);
    return;
  }
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int j = q / k;
    __pipeline_memcpy_async(dst + j * ds + q - j * k, src + q, 4);
  }
}

// The orders in which cuBLAS 12.8 (torch 2.11's bmm and einsum) sums the
// chunk's products on an H100 at chunks of 256, as probed on the card (leaves
// of +-2^40 and 1: a sum of the ones counts the leaves outside the two big
// ones' lowest common subtree): a sum over [0, k) is ``split`` > 0: two
// ascending chains over [0, split) and [split, k), then added; ``stride`` >
// 0: ``stride`` ascending chains over the residues mod stride, added in
// residue order; else one ascending chain.  Each chain's terms are fused
// multiply-adds.  Probed were k 16, 32, 33, 48, 50, 52, 64, 100 and 128; the
// ranges below carry each probed order to the widths between the probes that
// showed it, which is a guess there, and every width outside them takes one
// ascending chain.  Only k 50 is held to cuBLAS bit for bit by a card test
// (tests/test_torch_transr_fast.py); elsewhere an order that differs parts
// the kernel from chunk_update_ by an ulp here and there, as on random tables.
struct Order {
  int split, stride;
};

// A row times W (chunk_update_'s projections, t·W and h·W).
__device__ __forceinline__ Order projection_order(int k) {
  return {16 <= k && k <= 52 || k == 64 ? (k + 1) / 2 : 0, 0};
}
// W times a direction (W x+, W x−).
__device__ __forceinline__ Order direction_order(int k) { return {16 <= k && k <= 52 ? (k + 1) / 2 : 0, 0}; }
// The descent's pair rows times W (p).
__device__ __forceinline__ Order pair_order(int k) { return {48 <= k && k <= 64 ? k / 2 : 0, 0}; }
// W + ΔW times tmp.
__device__ __forceinline__ Order step_order(int k) { return {0, 48 <= k && k <= 52 ? 16 : 0}; }

// out[r, i] = sum_j a[r, j] w[j, i] for the N shared rows a (row stride k),
// each sum in the order ``o`` (a split, or one chain); thread i takes column
// i of every row.  w has row stride ws.
template <int N>
__device__ __forceinline__ void rows_times_w(float* out, const float* a, const float* w, int ws, int k, Order o) {
  const int h = o.split > 0 ? o.split : k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    float lo[N], hi[N];
#pragma unroll
    for (int r = 0; r < N; ++r) lo[r] = hi[r] = 0.f;
#pragma unroll 5
    for (int j = 0; j < h; ++j) {
      const float wv = w[j * ws + i];
#pragma unroll
      for (int r = 0; r < N; ++r) lo[r] = __fmaf_rn(a[r * k + j], wv, lo[r]);
    }
#pragma unroll 5
    for (int j = h; j < k; ++j) {
      const float wv = w[j * ws + i];
#pragma unroll
      for (int r = 0; r < N; ++r) hi[r] = __fmaf_rn(a[r * k + j], wv, hi[r]);
    }
#pragma unroll
    for (int r = 0; r < N; ++r) out[r * k + i] = h < k ? __fadd_rn(lo[r], hi[r]) : lo[r];
  }
}

// out[v, j] = sum_i w[j, i] x[v, i] for the N shared vectors x (row stride
// k), each sum in the order ``o``; thread j takes row j for every vector.
template <int N>
__device__ __forceinline__ void w_times_vecs(float* out, const float* x, const float* w, int ws, int k, Order o) {
  // Chains over i = first, first + step, ... < last, in turn; added in order.
  const int n_chains = o.stride > 0 ? o.stride : o.split > 0 ? 2 : 1;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float* wj = w + j * ws;
    float total[N];
    for (int c = 0; c < n_chains; ++c) {
      const int first = o.stride > 0 ? c : c == 0 ? 0 : o.split;
      const int last = o.stride > 0 || c == n_chains - 1 ? k : o.split;
      const int step = o.stride > 0 ? o.stride : 1;
      float acc[N];
#pragma unroll
      for (int v = 0; v < N; ++v) acc[v] = 0.f;
      for (int i = first; i < last; i += step) {
        const float wv = wj[i];
#pragma unroll
        for (int v = 0; v < N; ++v) acc[v] = __fmaf_rn(wv, x[v * k + i], acc[v]);
      }
#pragma unroll
      for (int v = 0; v < N; ++v) total[v] = c == 0 ? acc[v] : __fadd_rn(total[v], acc[v]);
    }
#pragma unroll
    for (int v = 0; v < N; ++v) out[v * k + j] = total[v];
  }
}

namespace cg = cooperative_groups;

constexpr int kNoOwner = 0x7fffffff;  // Scratch::owner between phases

// Shared memory of a block besides the dynamic floats (phases 1 and 3: W_r,
// row stride stride_of(k), and a sample's rows; a W_r item of phases 2 and
// 4: the matrix, row r and its staged samples).
union Shared {
  struct {
    float energy[2];
    int rel[kMaxRows];
  } score;
  struct {
    bool act[4];
  } ball;
  struct {
    int list[kMaxRows];
    unsigned char on[kMaxBatch][4];
    int n_list;
    float norm[kMaxK];
  } w;
};

// Samples a W_r item stages at a time at width k.
__host__ __device__ __forceinline__ int batch_of(int k) { return k <= 64 ? kMaxBatch : kMaxBatch / 2; }

// Chunk i of a run: its ids and flags.
__device__ __forceinline__ Chunk chunk_at(const Chunk& c, int i) {
  const size_t at = static_cast<size_t>(i) * c.rows;
  return Chunk{c.ph + at, c.pt + at, c.r + at, c.nh + at, c.nt + at, c.valid + at, c.rows, c.n_entities,
               c.n_relations, c.k};
}

// Phase 1, sample b: W_r and the five rows into shared memory, the four
// projections, the residuals, energies and decision.  Every sample claims
// its four entity rows (the lowest slot owns a row in phase 2).  A
// violating sample keeps its x+, x−, h − t, h' − t', W x+ and W x−, marks
// its slots in its rows' masks and itself in its relation's, and lists
// itself among the violators.  The first sample of each relation lists
// itself among the firsts.
template <bool kL1>
__device__ void score_sample(const Chunk& c, const float* table, const float* proj, const Scratch& s, float margin,
                             int b, int* counts, Shared& sh, float* smem) {
  __syncthreads();  // the block's previous item is done with shared memory
  const int k = c.k, ks = stride_of(k), rows = c.rows, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* w = smem;          // [k, ks] W_r
  float* e = w + k * ks;    // [5, k] h, t, h', t', r
  float* pr = e + 5 * k;    // [4, k] h·W, t·W, h'·W, t'·W
  float* x = pr + 4 * k;    // [2, k] x+, x−
  const int ih = c.ph[b], it = c.pt[b], ir = c.r[b], ia = c.nh[b], ib = c.nt[b];
  const bool valid = c.valid[b];
  copy_async(sh.score.rel, b + 1, [&](int q) { return c.r + q; });
  check_id(ih, c.n_entities);
  check_id(it, c.n_entities);
  check_id(ia, c.n_entities);
  check_id(ib, c.n_entities);
  check_id(ir, c.n_relations);
  const int row_of[5] = {ih, it, ia, ib, c.n_entities + ir};
  if (tid < 4) atomicMin(s.owner + row_of[tid], tid * rows + b);
  load_rows(w, ks, proj + static_cast<size_t>(ir) * k * k, k, k);
  copy_async(e, 5 * k, [&](int q) {
    const int which = q / k;
    return table + static_cast<size_t>(row_of[which]) * k + q - which * k;
  });
  copy_wait();
  __syncthreads();
  int f = b;  // the first sample of relation ir
  if (warp == kWarps - 1) {
    for (int base = 0; base < b; base += 32) {
      const unsigned m = __ballot_sync(kAll, base + lane < b && sh.score.rel[base + lane] == ir);
      if (m) {
        f = base + __ffs(m) - 1;
        break;
      }
    }
    if (lane == 0) {
      s.first_of[b] = f;
      if (f == b) {
        const int at = atomicAdd(counts, 1);
        s.firsts[2 * at] = b;
        s.firsts[2 * at + 1] = ir;
      }
      sh.score.rel[0] = f;  // for the block (rel is read no more)
    }
  }
  rows_times_w<4>(pr, e, w, ks, k, projection_order(k));
  __syncthreads();
  f = sh.score.rel[0];
  if (warp < 2) {  // warp 0 the positive, warp 1 the negative
    const float* tw = pr + (warp == 0 ? 1 : 3) * k;
    const float* hw = pr + (warp == 0 ? 0 : 2) * k;
    const float* rv = e + 4 * k;
    float res[4], terms[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = lane + 32 * m;
      res[m] = i < k ? __fsub_rn(__fsub_rn(tw[i], hw[i]), rv[i]) : 0.f;
      terms[m] = kL1 ? fabsf(res[m]) : __fmul_rn(res[m], res[m]);
      if (i < k) x[warp * k + i] = dir<kL1>(res[m]);
    }
    const float en = row_sum(terms, k);
    if (lane == 0) sh.score.energy[warp] = en;
  }
  __syncthreads();
  const float e_pos = sh.score.energy[0], e_neg = sh.score.energy[1];
  const bool viol = valid && __fadd_rn(e_pos, margin) > e_neg;
  if (tid == 0) {
    s.viol[b] = viol;
    s.loss[b] = viol ? __fsub_rn(__fadd_rn(margin, e_pos), e_neg) : 0.f;
    if (viol) {
      int* rec = s.violators + 5 * atomicAdd(counts + 1, 1);
      rec[0] = b;
      rec[1] = ih;
      rec[2] = it;
      rec[3] = ia != ih ? ia : ib;
      rec[4] = ir;
      atomicOr(s.w_masks + f * sample_words(rows) + (b >> 5), 1u << (b & 31));
    }
  }
  if (!viol) return;  // the whole block
  if (tid < 4) {
    const int slot = tid * rows + b;
    atomicOr(s.row_masks + static_cast<size_t>(row_of[tid]) * slot_words(rows) + (slot >> 5), 1u << (slot & 31));
  }
  float* out = s.step + static_cast<size_t>(b) * 6 * k;
  for (int q = tid; q < 2 * k; q += blockDim.x) out[q] = x[q];
  for (int q = tid; q < k; q += blockDim.x) {
    out[2 * k + q] = __fsub_rn(e[q], e[k + q]);
    out[3 * k + q] = __fsub_rn(e[2 * k + q], e[3 * k + q]);
  }
  w_times_vecs<2>(out + 4 * k, x, w, ks, k, direction_order(k));
}

// Warp 0: the samples of a mask, in order, into sh.w.list; the mask is
// cleared.
__device__ __forceinline__ void list_of(int rows, unsigned* mask, Shared& sh) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, words = sample_words(rows);
  int count = 0;
  for (int wd = 0; wd < words; ++wd) {
    const unsigned m = mask[wd];
    if (lane == 0) mask[wd] = 0u;
    if (m >> lane & 1u) sh.w.list[count + __popc(m & ((1u << lane) - 1))] = 32 * wd + lane;
    count += __popc(m);
  }
  if (lane == 0) sh.w.n_list = count;
}

// The shared [k, k] matrix a sphere-normed row by row into dst, the block
// together: each row's squares summed by a warp (in row_sum's order), its
// root by a thread, and each division by a thread, so that the roots and
// divisions (IEEE, each a subroutine of some hundred cycles) run side by
// side.
__device__ __forceinline__ void norm_rows(float* dst, const float* a, int k, Shared& sh) {
  const int warp = threadIdx.x >> 5;
  for (int j = warp; j < k; j += kWarps) {
    float v[4], sq[4];
    load_row(v, a + j * k, k);
#pragma unroll
    for (int m = 0; m < 4; ++m) sq[m] = __fmul_rn(v[m], v[m]);
    const float sum = row_sum(sq, k);
    if ((threadIdx.x & 31) == 0) sh.w.norm[j] = sum;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) sh.w.norm[j] = __fsqrt_rn(sh.w.norm[j]);
  __syncthreads();
  for (int q = threadIdx.x; q < k * k; q += blockDim.x) dst[q] = __fdiv_rn(a[q], sh.w.norm[q / k]);
}

// Phase 2, W_r item of first sample f, relation ir: W_r and row r take the
// steps of every violating sample of r, one after another in sample order
// (as index_add adds them), each element on its own; then they are
// sphere-normed and stored.  Every sample of r is in this item, so row r's
// owner is too.
__device__ void apply_w(const Chunk& c, float* table, float* proj, const Scratch& s, float lr, Shared& sh,
                        float* smem, int f, int ir) {
  __syncthreads();
  const int k = c.k, tid = threadIdx.x, warp = tid >> 5, batch = batch_of(k);
  float* tile = smem;           // [k, k] W_r
  float* rrow = tile + k * k;   // [k] row r
  float* stage = rrow + k;      // [batch, 4, k] x+, x−, h − t, h' − t'
  float* wr = proj + static_cast<size_t>(ir) * k * k;
  float* row_r = table + static_cast<size_t>(c.n_entities + ir) * k;
  list_of(c.rows, s.w_masks + f * sample_words(c.rows), sh);
  load_rows(tile, k, wr, k, k);
  copy_async(rrow, k, [&](int i) { return row_r + i; });
  copy_wait();
  __syncthreads();
  const int n_list = sh.w.n_list;
  for (int q0 = 0; q0 < n_list; q0 += batch) {
    const int nb = n_list - q0 < batch ? n_list - q0 : batch;
    copy_async(stage, nb * 4 * k, [&](int q) {
      const int sl = q / (4 * k);
      return s.step + static_cast<size_t>(sh.w.list[q0 + sl]) * 6 * k + q - sl * 4 * k;
    });
    copy_wait();
    __syncthreads();
    for (int el0 = tid; el0 < k * k; el0 += 4 * blockDim.x) {  // four elements a thread at a time
      int j[4], i[4];
      float acc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int el = el0 + u * blockDim.x < k * k ? el0 + u * blockDim.x : el0;
        j[u] = el / k;
        i[u] = el - j[u] * k;
        acc[u] = tile[el];
      }
      for (int sl = 0; sl < nb; ++sl) {
        const float* st = stage + sl * 4 * k;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float d = __fsub_rn(__fmul_rn(st[2 * k + j[u]], st[i[u]]), __fmul_rn(st[3 * k + j[u]], st[k + i[u]]));
          acc[u] = __fadd_rn(acc[u], __fmul_rn(lr, d));
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (el0 + u * blockDim.x < k * k) tile[el0 + u * blockDim.x] = acc[u];
      }
    }
    for (int i = tid; i < k; i += blockDim.x) {  // row r += lr (x+ − x−)
      float v = rrow[i];
      for (int sl = 0; sl < nb; ++sl) {
        v = __fadd_rn(v, __fmul_rn(lr, __fsub_rn(stage[sl * 4 * k + i], stage[sl * 4 * k + k + i])));
      }
      rrow[i] = v;
    }
    __syncthreads();
  }
  if (warp == 0) {
    float v[4];
    load_row(v, rrow, k);
    sphere_norm(v, k);
    store_row(row_r, v, k);
  }
  norm_rows(wr, tile, k, sh);
}

// A step's source row and factor (own_row).
struct Step {
  const float* first;
  float second;
};

// A warp on the row ``id`` that slot g claimed: if g owns it, the row takes
// the steps of its marked slots one after another in slot order (as
// index_add adds them) and is stored, sphere-normed if kNorm; the mask and
// the claim are cleared.  Slot q's step is coef · src[i] for
// (src, coef) = step(q); up to batch_of(k) steps at a time are copied into
// the warp's part of ``stage`` ([batch_of(k), k + 1] floats), all in flight
// at once, before they are added.
template <bool kNorm, typename F>
__device__ __forceinline__ void own_row(float* table, int k, int rows, const Scratch& s, int id, int g, float* stage,
                                        F step) {
  if (s.owner[id] != g) return;  // the whole warp
  const int lane = threadIdx.x & 31, words = slot_words(rows), batch = batch_of(k);
  float* coef = stage + batch * k;
  unsigned* mask = s.row_masks + static_cast<size_t>(id) * words;
  float v[4];
  load_row(v, table + static_cast<size_t>(id) * k, k);
  int n = 0;
  auto add_staged = [&]() {
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    for (int c = 0; c < n; ++c) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = lane + 32 * m;
        if (i < k) v[m] = __fadd_rn(v[m], __fmul_rn(coef[c], stage[c * k + i]));
      }
    }
    __syncwarp();
    n = 0;
  };
  for (int base = 0; base < words; base += 32) {
    const unsigned mine = base + lane < words ? mask[base + lane] : 0u;
    if (base + lane < words && mine) mask[base + lane] = 0u;
    for (int wd = 0; wd < 32 && base + wd < words; ++wd) {
      unsigned m = __shfl_sync(kAll, mine, wd);
      while (m) {
        const int q = 32 * (base + wd) + __ffs(m) - 1;
        m &= m - 1;
        const auto src = step(q);
        for (int i = lane; i < k; i += 32) __pipeline_memcpy_async(stage + n * k + i, src.first + i, 4);
        if (lane == 0) coef[n] = src.second;
        if (++n == batch) add_staged();
      }
    }
  }
  if (n > 0) add_staged();
  if (kNorm) sphere_norm(v, k);
  store_row(table + static_cast<size_t>(id) * k, v, k);
  if (lane == 0) s.owner[id] = kNoOwner;
}

// The row of entity slot g (role-major: h, t, h', t') of chunk c.
__device__ __forceinline__ int slot_row(const Chunk& c, int g) {
  const int role = g / c.rows, b = g - role * c.rows;
  return (role == 0 ? c.ph : role == 1 ? c.pt : role == 2 ? c.nh : c.nt)[b];
}

// Phase 3, a violating sample (its record: b, h, t, c, r); warp s takes pair
// s's decision.  A pair that steps claims its row and marks its slot in the
// row's mask; the sample keeps a, tmp and each stepping pair's delta
// (a − lr (W_r + ΔW) tmp) − a, and marks itself in its relation's mask.
__device__ void ball_sample(const Chunk& c, const float* table, const float* proj, const Scratch& s, float lr,
                            const int* rec, Shared& sh, float* smem) {
  __syncthreads();
  const int k = c.k, ks = stride_of(k), tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, rows = c.rows;
  float* w = smem;        // [k, ks] W_r, then W_r + ΔW
  float* a = w + k * ks;  // [4, k] the pairs' rows
  float* t = a + 4 * k;   // [4, k] p, then tmp
  float* q = t + 4 * k;   // [4, k] (W_r + ΔW) tmp
  const int b = rec[0], ir = rec[4];
  const int pair_rows[4] = {rec[1], rec[2], rec[3], c.n_entities + ir};
  load_rows(w, ks, proj + static_cast<size_t>(ir) * k * k, k, k);
  copy_async(a, 4 * k, [&](int o) {
    const int pair = o / k;
    return table + static_cast<size_t>(pair_rows[pair]) * k + o - pair * k;
  });
  copy_wait();
  __syncthreads();
  rows_times_w<4>(t, a, w, ks, k, pair_order(k));
  __syncthreads();
  float* out = s.ball + static_cast<size_t>(b) * 12 * k;  // a, tmp, delta: [3, 4, k]
  if (warp < 4) {
    float p[4], sq[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = lane + 32 * m;
      p[m] = i < k ? t[warp * k + i] : 0.f;
      sq[m] = __fmul_rn(p[m], p[m]);
    }
    const bool on = row_sum(sq, k) > 1.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = lane + 32 * m;
      if (i < k) {
        const float tmp = on ? __fmul_rn(2.f, p[m]) : 0.f;
        t[warp * k + i] = tmp;
        out[warp * k + i] = a[warp * k + i];
        out[4 * k + warp * k + i] = tmp;
      }
    }
    if (lane == 0) {
      sh.ball.act[warp] = on;
      s.act[4 * b + warp] = on;
      if (on) {
        const int slot = warp * rows + b;
        atomicMin(s.owner + pair_rows[warp], slot);
        atomicOr(s.row_masks + static_cast<size_t>(pair_rows[warp]) * slot_words(rows) + (slot >> 5),
                 1u << (slot & 31));
      }
    }
  }
  __syncthreads();
  const bool* act = sh.ball.act;
  if (!(act[0] || act[1] || act[2] || act[3])) return;
  if (tid == 0) atomicOr(s.w_masks + (rows + s.first_of[b]) * sample_words(rows) + (b >> 5), 1u << (b & 31));
  const float neg_lr = -lr;
  for (int o = tid; o < k * k; o += blockDim.x) {
    const int j = o / k, i = o - j * k;
    float d = 0.f;
#pragma unroll
    for (int pair = 0; pair < 4; ++pair) {
      if (act[pair]) d = __fmaf_rn(a[pair * k + j], t[pair * k + i], d);
    }
    w[j * ks + i] = __fadd_rn(w[j * ks + i], __fmul_rn(neg_lr, d));
  }
  __syncthreads();
  w_times_vecs<4>(q, t, w, ks, k, step_order(k));
  __syncthreads();
  for (int o = tid; o < 4 * k; o += blockDim.x) {
    const float av = a[o];
    if (act[o / k]) out[8 * k + o] = __fsub_rn(__fsub_rn(av, __fmul_rn(lr, q[o])), av);
  }
}

// Phase 4, W_r item of first sample f, relation ir: W_r adds ΔW of every
// sample of r with a stepping pair, one after another in sample order, each
// element on its own; ΔW is summed over the pairs again, as phase 3 summed
// it.
__device__ void ball_add_w(const Chunk& c, float* proj, const Scratch& s, float lr, Shared& sh, float* smem, int f,
                           int ir) {
  __syncthreads();
  const int rows = c.rows, k = c.k, tid = threadIdx.x, batch = batch_of(k);
  float* tile = smem;           // [k, k] W_r
  float* stage = smem + k * k;  // [batch, 8, k] a, tmp
  float* wr = proj + static_cast<size_t>(ir) * k * k;
  list_of(rows, s.w_masks + (rows + f) * sample_words(rows), sh);
  __syncthreads();
  const int n_list = sh.w.n_list;
  if (n_list == 0) return;
  load_rows(tile, k, wr, k, k);
  const float neg_lr = -lr;
  for (int q0 = 0; q0 < n_list; q0 += batch) {
    const int nb = n_list - q0 < batch ? n_list - q0 : batch;
    copy_async(stage, nb * 8 * k, [&](int q) {
      const int sl = q / (8 * k);
      return s.ball + static_cast<size_t>(sh.w.list[q0 + sl]) * 12 * k + q - sl * 8 * k;
    });
    if (tid < 4 * nb) sh.w.on[tid >> 2][tid & 3] = s.act[4 * sh.w.list[q0 + (tid >> 2)] + (tid & 3)];
    copy_wait();
    __syncthreads();
    for (int el0 = tid; el0 < k * k; el0 += 4 * blockDim.x) {  // four elements a thread at a time
      int j[4], i[4];
      float acc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int el = el0 + u * blockDim.x < k * k ? el0 + u * blockDim.x : el0;
        j[u] = el / k;
        i[u] = el - j[u] * k;
        acc[u] = tile[el];
      }
      for (int sl = 0; sl < nb; ++sl) {
        const float* st = stage + sl * 8 * k;
        const unsigned char* on = sh.w.on[sl];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float d = 0.f;
#pragma unroll
          for (int pair = 0; pair < 4; ++pair) {
            if (on[pair]) d = __fmaf_rn(st[pair * k + j[u]], st[4 * k + pair * k + i[u]], d);
          }
          acc[u] = __fadd_rn(acc[u], __fmul_rn(neg_lr, d));
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (el0 + u * blockDim.x < k * k) tile[el0 + u * blockDim.x] = acc[u];
      }
    }
    __syncthreads();
  }
  for (int el = tid; el < k * k; el += blockDim.x) wr[el] = tile[el];
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// Chunks [0, n_chunks) of the run at c, in order: each the four phases,
// with a grid-wide barrier after each.  The grid is every block that fits
// on the card at once (a cooperative launch); a phase's items go to the
// blocks in turn.  ``parity`` is that of the run's first chunk's index
// among the chunks run on this scratch (the counts of even and odd chunks
// alternate).  With ``stamps``, block 0 stores the card's clock (ns) as each
// chunk starts and as each of its phases ends: [n_chunks, 5].
template <bool kL1>
__global__ void __launch_bounds__(kThreads, 3)
transr_fast_chunks_kernel(const Chunk c0, int n_chunks, int parity, float* table, float* proj, const Scratch s,
                          float lr, float margin, float* loss, unsigned long long* stamps) {
  extern __shared__ float smem[];
  __shared__ Shared sh;
  cg::grid_group grid = cg::this_grid();
  const int rows = c0.rows, warp = threadIdx.x >> 5;
  const bool stamp = stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  const float neg_lr = -lr;
  float* stage_of_warp = smem + warp * batch_of(c0.k) * (c0.k + 1);  // a row owner's staged steps
  for (int i = 0; i < n_chunks; ++i) {
    const Chunk c = chunk_at(c0, i);
    const int par = (parity + i) & 1;
    int* counts = s.counts + 2 * par;
    if (stamp) stamps[5 * i] = global_ns();
    for (int b = blockIdx.x; b < rows; b += gridDim.x) score_sample<kL1>(c, table, proj, s, margin, b, counts, sh, smem);
    grid.sync();
    if (stamp) stamps[5 * i + 1] = global_ns();
    if (blockIdx.x == 0 && threadIdx.x < 2) s.counts[2 * (par ^ 1) + threadIdx.x] = 0;  // for the next chunk
    const int n_first = counts[0], row_items = (4 * rows + kWarps - 1) / kWarps;
    for (int item = blockIdx.x; item <= n_first + row_items; item += gridDim.x) {
      if (item < n_first) {
        apply_w(c, table, proj, s, lr, sh, smem, s.firsts[2 * item], s.firsts[2 * item + 1]);
      } else if (item < n_first + row_items) {
        __syncthreads();  // the block's previous item is done with shared memory
        const int g = (item - n_first) * kWarps + warp;
        if (g < 4 * rows) {
          own_row<true>(table, c.k, rows, s, slot_row(c, g), g, stage_of_warp, [&](int q) {
            const int role = q / rows;
            const float* st = s.step + static_cast<size_t>(q - role * rows) * 6 * c.k;
            // lr W x+, −lr W x+, −lr W x−, lr W x−
            return Step{st + (role < 2 ? 4 : 5) * c.k, role == 0 || role == 3 ? lr : neg_lr};
          });
        }
      } else if (threadIdx.x < 32) {  // the chunk's loss, the samples' terms in a fixed order
        const int lane = threadIdx.x;
        float acc = 0.f;
        for (int b = lane; b < rows; b += 32) acc = __fadd_rn(acc, s.loss[b]);
        for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_down_sync(kAll, acc, o));
        if (lane == 0) loss[i] = acc;
      }
    }
    grid.sync();
    if (stamp) stamps[5 * i + 2] = global_ns();
    const int n_viol = counts[1];
    for (int item = blockIdx.x; item < n_viol; item += gridDim.x) {
      ball_sample(c, table, proj, s, lr, s.violators + 5 * item, sh, smem);
    }
    grid.sync();
    if (stamp) stamps[5 * i + 3] = global_ns();
    const int pair_items = (4 * n_viol + kWarps - 1) / kWarps;
    for (int item = blockIdx.x; item < n_first + pair_items; item += gridDim.x) {
      if (item < n_first) {
        ball_add_w(c, proj, s, lr, sh, smem, s.firsts[2 * item], s.firsts[2 * item + 1]);
      } else {
        __syncthreads();  // the block's previous item is done with shared memory
        const int g = (item - n_first) * kWarps + warp;
        if (g < 4 * n_viol) {
          const int* rec = s.violators + 5 * (g >> 2);
          const int pair = g & 3, b = rec[0];
          if (s.act[4 * b + pair]) {
            own_row<false>(table, c.k, rows, s, pair == 3 ? c.n_entities + rec[4] : rec[1 + pair], pair * rows + b,
                           stage_of_warp, [&](int q) {
                             const int pq = q / rows;
                             return Step{s.ball + static_cast<size_t>(q - pq * rows) * 12 * c.k + 8 * c.k + pq * c.k,
                                         1.f};
                           });
          }
        }
      }
    }
    grid.sync();
    if (stamp) stamps[5 * i + 4] = global_ns();
  }
}

// Dynamic shared memory of a block: phase 1's or 3's W_r and rows, a W_r
// item's matrix, row r and staged samples, or the row owners' staged steps.
size_t smem_of(int k) {
  const size_t sample = static_cast<size_t>(k) * stride_of(k) + 12 * k;
  const size_t item = static_cast<size_t>(k) * k + k + static_cast<size_t>(batch_of(k)) * 8 * k;
  const size_t rows = static_cast<size_t>(kWarps) * batch_of(k) * (k + 1);
  const size_t most = sample > item ? sample : item;
  return sizeof(float) * (most > rows ? most : rows);
}

}  // namespace

// The grid of kb2e_transr_fast_chunks at width k on device `device`: the
// blocks that fit on the card at once, into *blocks.  Also lets the kernel
// take its shared memory.  Returns a CUDA error code, 0 on success.
extern "C" int kb2e_transr_fast_grid(int k, int l1, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = l1 ? reinterpret_cast<const void*>(transr_fast_chunks_kernel<true>)
                          : reinterpret_cast<const void*>(transr_fast_chunks_kernel<false>);
  const size_t smem = smem_of(k);
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem))) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  int per_sm = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  *blocks = per_sm * sms;
  return *blocks > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// Chunks [0, n_chunks) of `rows` samples each (ids [n_chunks, rows] from
// ph ...), in order, on `stream` of device `device`, in place on table
// [n_entities + n_relations, k] and proj [n_relations, k, k]; chunk i's loss
// is stored to loss[i].  One cooperative launch of `blocks` blocks (as
// kb2e_transr_fast_grid gives them).  ``parity``: that of the first chunk's
// index among the chunks run on this scratch.  Scratch: viol [rows] and act
// [rows, 4] bytes, sample_loss [rows], step [rows, 6, k] and ball
// [rows, 12, k] floats, first_of [rows], firsts [rows, 2] and violators
// [rows, 5] ints; counts [2, 2] ints, w_masks [2, rows, ceil(rows / 32)]
// and row_masks [n_entities + n_relations, ceil(4 rows / 32)] words zeroed
// and owner [n_entities + n_relations] ints set to INT_MAX before the first
// run (each run leaves them so).  ``stamps``: null, or [n_chunks, 5] for the
// kernel's clock.  Returns the launch's CUDA error code: 0 when it was
// accepted.
extern "C" int kb2e_transr_fast_chunks(float* table, float* proj, const int* ph, const int* pt, const int* r,
                                       const int* nh, const int* nt, const bool* valid, unsigned char* viol,
                                       float* sample_loss, float* step, int* first_of, int* firsts, int* violators,
                                       int* counts, unsigned char* act, float* ball, unsigned* w_masks,
                                       unsigned* row_masks, int* owner, float* loss, unsigned long long* stamps,
                                       int n_chunks, int parity, int rows, int k, int n_entities, int n_relations,
                                       int l1, int device, int blocks, float lr, float margin, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= 0 || k > kMaxK || rows <= 0 || rows > kMaxRows || n_entities <= 0 || n_relations <= 0 ||
      n_chunks <= 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Chunk c{ph, pt, r, nh, nt, valid, rows, n_entities, n_relations, k};
  Scratch s{viol, sample_loss, step, first_of, firsts, violators, counts, act, ball, w_masks, row_masks, owner};
  void* args[] = {&c, &n_chunks, &parity, &table, &proj, &s, &lr, &margin, &loss, &stamps};
  const void* kernel = l1 ? reinterpret_cast<const void*>(transr_fast_chunks_kernel<true>)
                          : reinterpret_cast<const void*>(transr_fast_chunks_kernel<false>);
  return static_cast<int>(cudaLaunchCooperativeKernel(kernel, blocks, kThreads, args, smem_of(k),
                                                      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* kb2e_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
