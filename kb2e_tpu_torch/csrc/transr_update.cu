// Reference-exact sequential TransR update (parity mode), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// kb2e_tpu/ops/pallas_update.py::transr_sequential_update (body
// _make_transr_kernel, projector _transr_ball_value, "K5").  One batch of the
// reference's SGD (transr/trainer.cpp:118-191), one sample at a time, in
// order.  W_r is laid out [j, i] (input dim j, output dim i), so a row
// projects as a.W.  On the batch-start snapshot:
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
// but the samples form one chain, and each projector trip inside a sample is
// itself a chain of k dependent block reductions (one per output dim), on top
// of about a dozen more per violating sample and one per projector test.
//
// Design, against the TPU kernel's sequential grid with one step per sample,
// row and matrix DMAs between HBM and VMEM, and a transposed W rotated one
// row per step:
//  * one block walks the B samples in order; thread c owns coordinate c of
//    every row (blockDim = k rounded up to a warp, k <= 224), so every table
//    read-modify-write of a row is program-ordered inside one thread;
//  * the working W_r of a violating sample lives in shared memory for both
//    directions (k x ld floats, ld = k | 1: odd, so a warp walking a row or a
//    column hits 32 banks); the snapshot W_r is read from device memory,
//    which nothing writes, so shared memory holds one matrix, not two
//    (k = 224 is the most that fits in the 227 KB a block may have; above
//    48 KB the launch opts in to dynamic shared memory);
//  * a row times W (the energies, every projector test) is one running sum
//    per output dim i in thread i; W.x and the row norms of W one running sum
//    per input dim j in thread j; the trip's dot over j is a block reduction;
//  * a block reduction sums each warp with shuffles and the warps' partial
//    sums in shared memory in a fixed order, so every thread gets the same
//    bits and takes the same branch (the decision, every projector test); two
//    shared buffers alternate, so one barrier per reduction suffices;
//  * the relation row stays in a register across both directions; the next
//    sample's indices and snapshot coordinates are loaded during the current
//    one;
//  * the arithmetic is rounded step by step (the _rn intrinsics keep nvcc
//    from fusing multiply-adds), and the plain PyTorch version
//    (ops/transr_update.py) rounds the same steps and sums in these orders,
//    so the two agree bit for bit.
// The caller passes the outputs as copies of the snapshot, zeroes *loss, and
// checks that every id lies in its table.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 224;
constexpr int kMaxThreads = kMaxK;  // a multiple of the warp
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kStaticSmemLimit = 48 * 1024;

struct Sample {
  int h, t, r, nh, nt;
  bool valid;
  // This thread's coordinate of the snapshot rows: h, t, r, h', t'.
  float eh, et, er, enh, ent;
};

// Sums each of v[0..n) over the block; every thread gets the same sums.
template <int n>
__device__ __forceinline__ void block_sum(float (&v)[n], float (*buf)[kMaxWarps], int nwarps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
    if (lane == 0) buf[i][warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float s = buf[i][0];
    for (int w = 1; w < nwarps; ++w) s = __fadd_rn(s, buf[i][w]);
    v[i] = s;
  }
}

__device__ __forceinline__ float sphere(float v, float sumsq) { return __fdiv_rn(v, __fsqrt_rn(sumsq)); }

size_t smem_bytes(int k) { return static_cast<size_t>(k * (k | 1) + 7 * k) * sizeof(float); }

template <bool kL1>
__global__ void __launch_bounds__(kMaxThreads, 1)
transr_update_kernel(const float* __restrict__ snap_e,  // [n, k] batch-start snapshot
                     const float* __restrict__ snap_r,  // [R, k]
                     const float* __restrict__ snap_w,  // [R, k, k], [j, i]
                     float* __restrict__ ent,           // [n, k] output, = snap_e on entry
                     float* __restrict__ rel,           // [R, k] output, = snap_r on entry
                     float* __restrict__ wout,          // [R, k, k] output, = snap_w on entry
                     const int* __restrict__ ph, const int* __restrict__ pt,
                     const int* __restrict__ pr, const int* __restrict__ pnh,
                     const int* __restrict__ pnt, const bool* __restrict__ valid,
                     float* __restrict__ loss_out,  // []
                     int* __restrict__ viol_out,    // [b]
                     int* __restrict__ trips_out,   // [b, 2] per sample: fired projector trips,
                                                    // projector calls stopped at max_iters
                     int k, int b, int max_iters, float lr, float margin) {
  extern __shared__ float smem[];
  __shared__ float red[2][3][kMaxWarps];
  const int ld = k | 1;
  float* W = smem;               // [k][ld] the working W_r
  float* stage = W + k * ld;     // [4][k] snapshot rows h, t, h', t' of the energies
  float* A = stage + 4 * k;      // [k] the row under the projector
  float* D = A + k;              // [k] h - t of the snapshot
  float* X = D + k;              // [k] x
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

  auto load = [&](int i) {
    Sample s;
    s.h = ph[i];
    s.t = pt[i];
    s.r = pr[i];
    s.nh = pnh[i];
    s.nt = pnt[i];
    s.valid = valid[i];
    s.eh = live ? snap_e[(size_t)s.h * k + c] : 0.f;
    s.et = live ? snap_e[(size_t)s.t * k + c] : 0.f;
    s.er = live ? snap_r[(size_t)s.r * k + c] : 0.f;
    s.enh = live ? snap_e[(size_t)s.nh * k + c] : 0.f;
    s.ent = live ? snap_e[(size_t)s.nt * k + c] : 0.f;
    return s;
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
    float hv = live ? ent[(size_t)h * k + c] : 0.f;
    float tv = (live && !alias) ? ent[(size_t)t * k + c] : 0.f;
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

  float loss = 0.f;
  Sample cur = load(0);
  for (int i = 0; i < b; ++i) {
    Sample nxt;
    if (i + 1 < b) nxt = load(i + 1);  // the snapshot is read-only: prefetch

    if (live) {
      stage[c] = cur.eh;
      stage[k + c] = cur.et;
      stage[2 * k + c] = cur.enh;
      stage[3 * k + c] = cur.ent;
    }
    __syncthreads();
    const float* wsnap = snap_w + (size_t)cur.r * k * k;
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
    const float rp = __fsub_rn(__fsub_rn(tp, hp), cur.er);  // 0 past k
    const float rn = __fsub_rn(__fsub_rn(ntp, nhp), cur.er);
    float e[2];
    float xp, xn;
    if (kL1) {
      e[0] = fabsf(rp);
      e[1] = fabsf(rn);
      xp = live ? (__fmul_rn(2.f, rp) > 0.f ? 1.f : -1.f) : 0.f;
      xn = live ? (__fmul_rn(2.f, rn) > 0.f ? 1.f : -1.f) : 0.f;
    } else {
      e[0] = __fmul_rn(rp, rp);
      e[1] = __fmul_rn(rn, rn);
      xp = __fmul_rn(2.f, rp);
      xn = __fmul_rn(2.f, rn);
    }
    block_sum<2>(e, red[buf], nwarps);
    buf ^= 1;
    const bool viol = cur.valid && __fadd_rn(e[0], margin) > e[1];
    int trips[2] = {0, 0};  // fired projector trips, projector calls stopped at max_iters
    if (viol) {             // the same for every thread: a uniform branch
      float* wdst = wout + (size_t)cur.r * k * k;
      if (live) {
        for (int j = 0; j < k; ++j) W[j * ld + c] = wdst[(size_t)j * k + c];
      }
      float rw = live ? rel[(size_t)cur.r * k + c] : 0.f;
      direction(rw, wsnap, cur.h, cur.t, xp, cur.eh, cur.et, -1.f, trips);
      direction(rw, wsnap, cur.nh, cur.nt, xn, cur.enh, cur.ent, 1.f, trips);
      __syncthreads();  // every thread's writes to W before the column write-back
      if (live) {
        for (int j = 0; j < k; ++j) wdst[(size_t)j * k + c] = W[j * ld + c];
        rel[(size_t)cur.r * k + c] = rw;
      }
    }
    if (c == 0) {
      viol_out[i] = viol;
      trips_out[2 * i] = trips[0];
      trips_out[2 * i + 1] = trips[1];
      if (viol) loss = __fadd_rn(loss, __fsub_rn(__fadd_rn(margin, e[0]), e[1]));
    }
    cur = nxt;
  }
  if (c == 0) *loss_out = loss;
}

template <bool kL1>
cudaError_t launch(const float* snap_e, const float* snap_r, const float* snap_w, float* ent, float* rel,
                   float* w, const int* ph, const int* pt, const int* r, const int* nh, const int* nt,
                   const bool* valid, float* loss, int* viol, int* trips, int k, int b, int max_iters, float lr,
                   float margin, cudaStream_t stream) {
  const size_t bytes = smem_bytes(k);
  if (bytes > kStaticSmemLimit) {
    // Above 48 KB a block gets its dynamic shared memory only on request.
    const cudaError_t err = cudaFuncSetAttribute(transr_update_kernel<kL1>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const int threads = (k + 31) / 32 * 32;
  transr_update_kernel<kL1><<<1, threads, bytes, stream>>>(snap_e, snap_r, snap_w, ent, rel, w, ph, pt, r, nh,
                                                            nt, valid, loss, viol, trips, k, b, max_iters, lr,
                                                            margin);
  return cudaGetLastError();
}

}  // namespace

// Launches one block on `stream` of device `device` and returns
// cudaGetLastError(): 0 when the launch was accepted.
extern "C" int kb2e_transr_update(const float* snap_e, const float* snap_r, const float* snap_w, float* ent,
                                  float* rel, float* w, const int* ph, const int* pt, const int* r,
                                  const int* nh, const int* nt, const bool* valid, float* loss, int* viol,
                                  int* trips, int k, int b, int max_iters, int l1, int device, float lr,
                                  float margin, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxK || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = l1 ? launch<true>(snap_e, snap_r, snap_w, ent, rel, w, ph, pt, r, nh, nt, valid, loss, viol, trips, k,
                          b, max_iters, lr, margin, s)
           : launch<false>(snap_e, snap_r, snap_w, ent, rel, w, ph, pt, r, nh, nt, valid, loss, viol, trips, k,
                           b, max_iters, lr, margin, s);
  return static_cast<int>(err);
}

extern "C" const char* kb2e_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
