// Reference-exact sequential TransR update (parity mode), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// kb2e_tpu/ops/pallas_update.py::transr_sequential_update (body
// _make_transr_kernel, projector _transr_ball_value, "K5").  One batch of the
// reference's SGD (transr/trainer.cpp:118-191), with the result of running
// the samples one at a time, in order.  W_r is laid out [j, i] (input dim j,
// output dim i), so a row projects as a.W.  On the batch-start snapshot:
//   res = t.W - h.W - r;  e = sum |res| (L1) or sum res^2 (L2);
//   x = +1 where 2 res > 0 else -1 (L1), or x = 2 res (L2);
//   if valid and e_p + margin > e_n:
//     loss += margin + e_p - e_n;
//     per direction (beta = -1 for the positive triple, then +1 for the
//     corrupted one), with h, t and W from the snapshot, on the output tables:
//       W_r -= beta lr outer(h - t, x);  wx = W.x (snapshot W);
//       h -= beta lr wx;  t += beta lr wx;  r -= beta lr x;
//       sphere-norm r, h, t and every row j of W_r;
//       transRNorm (h, W_r), then (t, W_r), then (r, W_r)
// where transRNorm(a, W) (transr/trainer.cpp:34-64) runs up to max_iters
// trips while |a.W|^2 > 1, a trip walking the output dims i in order:
//   tmp = 2 W[:, i].a;  W[:, i] -= lr tmp a;  a -= lr tmp W[:, i].
// The third call constrains the relation vector, the intent of the
// reference's bug B2.  When h == t both deltas land on the one row, which is
// sphere-normed twice and projected twice (pallas_update.py:579-580).
//
// Bound on an H100: latency, not bytes or operations.  A launch must move the
// three tables in and out once (121 MB at FB15k, k = 100: 0.036 ms at
// 3.35 TB/s) and does some millions of fp32 operations a violating sample,
// but each projector trip inside a sample is a chain of k dependent block
// reductions (one per output dim), on top of about a dozen more per
// violating sample and one per projector test, and samples that share a row
// must run one after the other.
//
// Design, against the TPU kernel's sequential grid with one step per sample,
// row and matrix DMAs between HBM and VMEM, and a transposed W rotated one
// row per step.  Three launches:
//  1. transr_decide_kernel, one block per sample: the energies, the decision,
//     the loss term and x, from the snapshot alone, into scratch.  The four
//     rows times W_r leave the chain of dependent samples;
//  2. ordered::loss_kernel, one block: the loss in sample order;
//  3. transr_apply_kernel, a persistent grid of every block that fits on the
//     card at once: the violating samples' updates, side by side where they
//     share no row, each after the earlier samples of its rows (ordered.cuh;
//     the wrapper computes those predecessors between launches 1 and 3).
// Inside one sample, as the single-block kernel it replaced:
//  * thread c owns coordinate c of every row (blockDim = k rounded up to a
//    warp, k <= 224), so every table read-modify-write of a row is
//    program-ordered inside one thread;
//  * the working W_r of a violating sample lives in shared memory for both
//    directions (k x ld floats, ld = k | 1: odd, so a warp walking a row or a
//    column hits 32 banks); the snapshot W_r is read from device memory,
//    which nothing writes, so shared memory holds one matrix, not two
//    (k = 224 is the most that fits in the 227 KB a block may have; above
//    48 KB the launch opts in to dynamic shared memory);
//  * a row times W (every projector test) is one running sum per output dim
//    i in thread i; W.x and the row norms of W one running sum per input dim
//    j in thread j; the trip's dot over j is a block reduction;
//  * a block reduction sums each warp with shuffles and the warps' partial
//    sums in shared memory in a fixed order, so every thread gets the same
//    bits and takes the same branch (the decision, every projector test); two
//    shared buffers alternate, so one barrier per reduction suffices;
//  * the relation row stays in a register across both directions; the
//    snapshot coordinates and x are loaded before the wait on predecessors;
//  * the arithmetic is rounded step by step (the _rn intrinsics keep nvcc
//    from fusing multiply-adds), and the plain PyTorch version
//    (ops/transr_update.py) rounds the same steps and sums in these orders,
//    so the two agree bit for bit.
// The caller passes the outputs as copies of the snapshot, zeroes *loss and
// the done flags and ticket, and checks that every id lies in its table.

#include <cuda_runtime.h>

#include "ordered.cuh"

namespace {

using ordered::sphere;

constexpr int kMaxK = 224;
constexpr int kMaxThreads = kMaxK;  // a multiple of the warp
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kStaticSmemLimit = 48 * 1024;
constexpr int kRows = 5;  // schedule rows a sample lists: h, t, h', t', and its relation (r and W_r)

template <int n>
__device__ __forceinline__ void block_sum(float (&v)[n], float (*buf)[kMaxWarps], int nwarps) {
  ordered::block_sum<n, kMaxWarps>(v, buf, nwarps);
}

size_t decide_smem_bytes(int k) { return static_cast<size_t>(4 * k) * sizeof(float); }
size_t apply_smem_bytes(int k) { return static_cast<size_t>(k * (k | 1) + 3 * k) * sizeof(float); }
int threads_for(int k) { return (k + 31) / 32 * 32; }

// Launch 1: sample blockIdx.x's energies on the snapshot; writes its x_p and
// x_n to xs[i][0..2k), margin + e_p - e_n to terms[i], and the decision.
template <bool kL1>
__global__ void __launch_bounds__(kMaxThreads)
transr_decide_kernel(const float* __restrict__ snap_e,  // [n, k] batch-start snapshot
                     const float* __restrict__ snap_r,  // [R, k]
                     const float* __restrict__ snap_w,  // [R, k, k], [j, i]
                     const int* __restrict__ ph, const int* __restrict__ pt,
                     const int* __restrict__ pr, const int* __restrict__ pnh,
                     const int* __restrict__ pnt, const bool* __restrict__ valid,
                     float* __restrict__ xs,     // [b, 2, k]
                     float* __restrict__ terms,  // [b]
                     int* __restrict__ viol_out, int k, float margin) {
  extern __shared__ float stage[];  // [4][k] snapshot rows h, t, h', t'
  __shared__ float red[2][kMaxWarps];
  const int i = blockIdx.x;
  const int c = threadIdx.x;
  const bool live = c < k;
  const int nwarps = blockDim.x >> 5;
  const int r = pr[i];
  if (live) {
    stage[c] = snap_e[(size_t)ph[i] * k + c];
    stage[k + c] = snap_e[(size_t)pt[i] * k + c];
    stage[2 * k + c] = snap_e[(size_t)pnh[i] * k + c];
    stage[3 * k + c] = snap_e[(size_t)pnt[i] * k + c];
  }
  const float er = live ? snap_r[(size_t)r * k + c] : 0.f;
  __syncthreads();
  const float* wsnap = snap_w + (size_t)r * k * k;
  float hp = 0.f, tp = 0.f, nhp = 0.f, ntp = 0.f;
  if (live) {
    for (int j = 0; j < k; ++j) {
      const float w = __ldg(wsnap + (size_t)j * k + c);
      hp = __fadd_rn(hp, __fmul_rn(stage[j], w));
      tp = __fadd_rn(tp, __fmul_rn(stage[k + j], w));
      nhp = __fadd_rn(nhp, __fmul_rn(stage[2 * k + j], w));
      ntp = __fadd_rn(ntp, __fmul_rn(stage[3 * k + j], w));
    }
  }
  const float rp = __fsub_rn(__fsub_rn(tp, hp), er);  // 0 past k
  const float rn = __fsub_rn(__fsub_rn(ntp, nhp), er);
  float e[2];
  float xp, xn;
  if (kL1) {
    e[0] = fabsf(rp);
    e[1] = fabsf(rn);
    xp = __fmul_rn(2.f, rp) > 0.f ? 1.f : -1.f;
    xn = __fmul_rn(2.f, rn) > 0.f ? 1.f : -1.f;
  } else {
    e[0] = __fmul_rn(rp, rp);
    e[1] = __fmul_rn(rn, rn);
    xp = __fmul_rn(2.f, rp);
    xn = __fmul_rn(2.f, rn);
  }
  block_sum<2>(e, red, nwarps);
  if (live) {
    xs[(size_t)i * 2 * k + c] = xp;
    xs[(size_t)i * 2 * k + k + c] = xn;
  }
  if (c == 0) {
    viol_out[i] = valid[i] && __fadd_rn(e[0], margin) > e[1];
    terms[i] = __fsub_rn(__fadd_rn(margin, e[0]), e[1]);
  }
}

// Launch 3: the violating samples' updates in the reference's per-row order.
__global__ void __launch_bounds__(kMaxThreads, 2)
transr_apply_kernel(const float* __restrict__ snap_e,  // [n, k] batch-start snapshot
                    const float* __restrict__ snap_w,  // [R, k, k], [j, i]
                    float* ent,                        // [n, k] output, = snap_e on entry
                    float* rel,                        // [R, k] output, = snap_r on entry
                    float* wout,                       // [R, k, k] output, = snap_w on entry
                    const int* __restrict__ ph, const int* __restrict__ pt,
                    const int* __restrict__ pr, const int* __restrict__ pnh,
                    const int* __restrict__ pnt,
                    const int* __restrict__ viol,  // [b] from launch 1
                    const float* __restrict__ xs,  // [b, 2, k] from launch 1
                    const int* __restrict__ pred,  // [b, kRows] latest earlier update of each row, -1: none
                    int* order,                    // [b + 1] zeroed: done flags, then the ticket
                    int* __restrict__ trips_out,   // [b, 2] per sample: fired projector trips,
                                                   // projector calls stopped at max_iters
                    int k, int b, int max_iters, float lr) {
  extern __shared__ float smem[];
  __shared__ float red[2][3][kMaxWarps];
  __shared__ int slot;
  const int ld = k | 1;
  float* W = smem;            // [k][ld] the working W_r
  float* A = W + k * ld;      // [k] the row under the projector
  float* D = A + k;           // [k] h - t of the snapshot
  float* X = D + k;           // [k] x
  const int c = threadIdx.x;
  const bool live = c < k;
  const int nwarps = blockDim.x >> 5;
  int buf = 0;  // the reduction buffer to use next

  // Threads past k hold no coordinate: every value they carry stays 0, so
  // they add 0 to every sum.
  auto sum1 = [&](float v) {
    float s[1] = {live ? v : 0.f};
    block_sum<1>(s, red[buf], nwarps);
    buf ^= 1;
    return s[0];
  };

  // transRNorm on the register row a and the shared W, as
  // pallas_update.py::_transr_ball_value with the output dims in order.
  auto ball = [&](float& a, int (&trips)[2]) {
    int it = 0;
    for (; it < max_iters; ++it) {
      if (live) A[c] = a;
      __syncthreads();  // A, and every thread's writes to W
      float p = 0.f;
      if (live) {
        for (int j = 0; j < k; ++j) p = __fadd_rn(p, __fmul_rn(A[j], W[j * ld + c]));
      }
      if (!(sum1(__fmul_rn(p, p)) > 1.f)) break;  // the same for every thread
      float* wrow = W + c * ld;                  // thread c is input dim j = c
      for (int i = 0; i < k; ++i) {
        float w = live ? wrow[i] : 0.f;
        const float s = __fmul_rn(lr, __fmul_rn(2.f, sum1(__fmul_rn(w, a))));
        if (live) {
          w = __fsub_rn(w, __fmul_rn(s, a));
          wrow[i] = w;
          a = __fsub_rn(a, __fmul_rn(s, w));
        }
      }
    }
    trips[0] += it;
    trips[1] += it == max_iters;
  };

  // One gradientUpdate (transr/trainer.cpp:144-191) with sign beta on the
  // register relation row rw and the shared W; x, he and te come from the
  // snapshot, wsnap is the snapshot W_r.
  auto direction = [&](float& rw, const float* __restrict__ wsnap, int h, int t, float x, float he, float te,
                       float beta, int (&trips)[2]) {
    const bool alias = h == t;
    const float c1 = -beta * lr, c2 = beta * lr;
    if (live) {
      D[c] = __fsub_rn(he, te);
      X[c] = x;
    }
    __syncthreads();
    float wx = 0.f;
    if (live) {
      // W -= beta lr outer(h - t, x): thread c takes column c.
      for (int j = 0; j < k; ++j) W[j * ld + c] = __fadd_rn(W[j * ld + c], __fmul_rn(c1, __fmul_rn(D[j], x)));
      // (W.x)_c over the snapshot row c.
      const float* row = wsnap + (size_t)c * k;
      for (int i = 0; i < k; ++i) wx = __fadd_rn(wx, __fmul_rn(__ldg(row + i), X[i]));
    }
    float hv = live ? __ldcg(ent + (size_t)h * k + c) : 0.f;
    float tv = (live && !alias) ? __ldcg(ent + (size_t)t * k + c) : 0.f;
    hv = __fadd_rn(hv, __fmul_rn(c1, wx));
    if (alias) {
      hv = __fadd_rn(hv, __fmul_rn(c2, wx));
    } else {
      tv = __fadd_rn(tv, __fmul_rn(c2, wx));
    }
    rw = __fadd_rn(rw, __fmul_rn(c1, x));
    if (alias) {
      float sq[2] = {live ? __fmul_rn(rw, rw) : 0.f, live ? __fmul_rn(hv, hv) : 0.f};
      block_sum<2>(sq, red[buf], nwarps);
      buf ^= 1;
      rw = sphere(rw, sq[0]);
      hv = sphere(hv, sq[1]);
      hv = sphere(hv, sum1(__fmul_rn(hv, hv)));
    } else {
      float sq[3] = {live ? __fmul_rn(rw, rw) : 0.f, live ? __fmul_rn(hv, hv) : 0.f,
                     live ? __fmul_rn(tv, tv) : 0.f};
      block_sum<3>(sq, red[buf], nwarps);
      buf ^= 1;
      rw = sphere(rw, sq[0]);
      hv = sphere(hv, sq[1]);
      tv = sphere(tv, sq[2]);
    }
    // Every row j of W onto the unit sphere: thread c takes row c (the block
    // sum above ordered every thread's column writes before these reads).
    if (live) {
      float* wrow = W + c * ld;
      float s = 0.f;
      for (int i = 0; i < k; ++i) s = __fadd_rn(s, __fmul_rn(wrow[i], wrow[i]));
      const float nrm = __fsqrt_rn(s);
      for (int i = 0; i < k; ++i) wrow[i] = __fdiv_rn(wrow[i], nrm);
    }
    ball(hv, trips);
    ball(alias ? hv : tv, trips);
    ball(rw, trips);
    if (live) {
      ent[(size_t)h * k + c] = hv;
      if (!alias) ent[(size_t)t * k + c] = tv;
    }
  };

  int* done = order;
  for (;;) {
    const int i = ordered::next_ticket(order + b, &slot);
    if (i >= b) break;
    int trips[2] = {0, 0};  // fired projector trips, projector calls stopped at max_iters
    if (viol[i]) {          // the same for every thread: a uniform branch
      const int h = ph[i], t = pt[i], r = pr[i], nh = pnh[i], nt = pnt[i];
      // The snapshot and x: nothing writes them, so they load before the wait.
      const float eh = live ? __ldg(snap_e + (size_t)h * k + c) : 0.f;
      const float et = live ? __ldg(snap_e + (size_t)t * k + c) : 0.f;
      const float enh = live ? __ldg(snap_e + (size_t)nh * k + c) : 0.f;
      const float ent_ = live ? __ldg(snap_e + (size_t)nt * k + c) : 0.f;
      const float xp = live ? __ldg(xs + (size_t)i * 2 * k + c) : 0.f;
      const float xn = live ? __ldg(xs + (size_t)i * 2 * k + k + c) : 0.f;
      ordered::wait_for(done, pred + (size_t)i * kRows, kRows);
      const float* wsnap = snap_w + (size_t)r * k * k;
      float* wdst = wout + (size_t)r * k * k;
      if (live) {
        for (int j = 0; j < k; ++j) W[j * ld + c] = __ldcg(wdst + (size_t)j * k + c);
      }
      float rw = live ? __ldcg(rel + (size_t)r * k + c) : 0.f;
      direction(rw, wsnap, h, t, xp, eh, et, -1.f, trips);
      direction(rw, wsnap, nh, nt, xn, enh, ent_, 1.f, trips);
      __syncthreads();  // every thread's writes to W before the column write-back
      if (live) {
        for (int j = 0; j < k; ++j) wdst[(size_t)j * k + c] = W[j * ld + c];
        rel[(size_t)r * k + c] = rw;
      }
      ordered::publish(done, i);
    }
    if (c == 0) {
      trips_out[2 * i] = trips[0];
      trips_out[2 * i + 1] = trips[1];
    }
  }
}

// Above 48 KB a block gets its dynamic shared memory only on request; the
// carveout preference lets several such blocks share an SM.
cudaError_t prepare_apply(int k) {
  const size_t bytes = apply_smem_bytes(k);
  if (bytes > kStaticSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(transr_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(transr_apply_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Launches 1 and 2 on `stream` of device `device`: the decisions, x and the
// loss.  Returns cudaGetLastError(): 0 when both launches were accepted.
extern "C" int kb2e_transr_decide(const float* snap_e, const float* snap_r, const float* snap_w, const int* ph,
                                  const int* pt, const int* r, const int* nh, const int* nt, const bool* valid,
                                  float* xs, float* terms, int* viol, float* loss, int k, int b, int l1, int device,
                                  float margin, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(k);
  if (l1) {
    transr_decide_kernel<true><<<b, threads, decide_smem_bytes(k), s>>>(snap_e, snap_r, snap_w, ph, pt, r, nh, nt,
                                                                        valid, xs, terms, viol, k, margin);
  } else {
    transr_decide_kernel<false><<<b, threads, decide_smem_bytes(k), s>>>(snap_e, snap_r, snap_w, ph, pt, r, nh, nt,
                                                                         valid, xs, terms, viol, k, margin);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ordered::loss_kernel<<<1, ordered::kLossThreads, 0, s>>>(viol, terms, loss, b);
  return static_cast<int>(cudaGetLastError());
}

// Launch 3 on `stream` of device `device`, over min(b, resident blocks).
// Returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int kb2e_transr_apply(const float* snap_e, const float* snap_w, float* ent, float* rel, float* w,
                                 const int* ph, const int* pt, const int* r, const int* nh, const int* nt,
                                 const int* viol, const float* xs, const int* pred, int* order, int* trips, int k,
                                 int b, int max_iters, int device, float lr, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxK || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  err = prepare_apply(k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = threads_for(k);
  int per_sm = 0, total = 0;
  err = ordered::resident_blocks(transr_apply_kernel, threads, apply_smem_bytes(k), device, &per_sm, &total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = total < b ? total : b;
  transr_apply_kernel<<<grid, threads, apply_smem_bytes(k), static_cast<cudaStream_t>(stream)>>>(
      snap_e, snap_w, ent, rel, w, ph, pt, r, nh, nt, viol, xs, pred, order, trips, k, b, max_iters, lr);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of launch 3 resident on one SM at width k, into *per_sm.
extern "C" int kb2e_transr_blocks_per_sm(int k, int device, int* per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  err = prepare_apply(k);
  if (err != cudaSuccess) return static_cast<int>(err);
  int total = 0;
  return static_cast<int>(ordered::resident_blocks(transr_apply_kernel, threads_for(k), apply_smem_bytes(k), device,
                                                   per_sm, &total));
}

extern "C" const char* kb2e_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
