// Reference-exact sequential TransH update (parity mode), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// kb2e_tpu/ops/pallas_update.py::transh_sequential_update (body
// _make_transh_kernel, projector _orthogonality_project_value, "K4").  One
// batch of the reference's SGD (transh/trainer.cpp:11-58), one sample at a
// time, in order.  With w the relation's hyperplane normal, on the
// batch-start snapshot:
//   hs = w.h, ts = w.t, res = (t - ts w) - (h - hs w) - r,
//   e = sum |res|, x = +1 where 2 res > 0 else -1, sum_x = sum x w;
//   if valid and e_p + margin > e_n:
//     loss += margin + e_p - e_n;
//     per direction (beta = -1 for the positive triple, then +1 for the
//     corrupted one), on the output tables:
//       r, h += -beta lr x;  t += beta lr x;
//       w += beta lr (x (hs - ts) + sum_x (h_snap - t_snap));
//       ball-norm r, h, t; sphere-norm w;
//       project (r, w), then (h, w), then (t, w)   [common/utils.cpp:79-111]
// where project(a, b) is: b = b / |b|; s = 0; up to max_iters trips of
//   s' = s + sum b^2; b^ = b / sqrt(s'); if b^.a <= 0.1: b = b^, stop;
//   a -= lr b^; b = b^ - lr a; s = sqrt(s');
// then b = b / |b|.  When h == t both deltas land on the one row, which is
// ball-normed twice (the second norm reading the first's result) and
// projected twice (pallas_update.py:348-350, 376).
//
// Bound on an H100: latency, not bytes or operations.  A launch must move
// the three tables in and out once (14 MB at FB15k, k = 100: about 4 us at
// 3.35 TB/s) and does some hundred thousand fp32 operations per sample, but
// the samples form one chain: each violating sample waits on about thirty
// dependent block reductions (two before the decision; per direction one for
// the norms and at least four per projector call) and on reads of rows an
// earlier sample may have written.
//
// Design, against the TPU kernel's sequential grid with one step per sample
// and row DMAs between HBM and VMEM (the shape of K3, csrc/transe_update.cu):
//  * one block walks the B samples in order; thread c owns coordinate c of
//    every row (blockDim = k rounded up to a warp, k <= 1024), so every
//    table read-modify-write is program-ordered inside one thread and the
//    only traffic between threads is the block reductions;
//  * a block reduction sums each warp with shuffles and the warps' partial
//    sums in shared memory in a fixed order, so every thread gets the same
//    bits and takes the same branch (the decision, the ball norms, every
//    projector test); two shared buffers alternate, so one barrier per
//    reduction suffices;
//  * the energies read the snapshot, which nothing writes: the next sample's
//    indices and six snapshot coordinates are loaded while the current
//    sample is processed;
//  * the relation row r and the normal w stay in registers across both
//    directions, as the TPU kernel keeps them in VMEM slots 0 and 1;
//  * the arithmetic is rounded step by step (the _rn intrinsics keep nvcc
//    from fusing multiply-adds), and the plain PyTorch version
//    (ops/transh_update.py) rounds the same steps and sums over k in this
//    reduction order, so the two agree bit for bit.
// The caller passes the outputs as copies of the snapshot, zeroes *loss, and
// checks that every id lies in its table.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;

struct Sample {
  int h, t, r, nh, nt;
  bool valid;
  // This thread's coordinate of the snapshot rows: h, t, r, w, h', t'.
  float eh, et, er, ew, enh, ent;
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

__device__ __forceinline__ float ball(float v, float sumsq) {
  const float nrm = __fsqrt_rn(sumsq);
  return nrm > 1.f ? __fdiv_rn(v, nrm) : v;
}

__device__ __forceinline__ float sphere(float v, float sumsq) { return __fdiv_rn(v, __fsqrt_rn(sumsq)); }

__global__ void __launch_bounds__(kMaxThreads, 1)
transh_update_kernel(const float* __restrict__ snap_e,  // [n, k] batch-start snapshot
                     const float* __restrict__ snap_r,  // [R, k]
                     const float* __restrict__ snap_w,  // [R, k]
                     float* __restrict__ ent,           // [n, k] output, = snap_e on entry
                     float* __restrict__ rel,           // [R, k] output, = snap_r on entry
                     float* __restrict__ nrm,           // [R, k] output, = snap_w on entry
                     const int* __restrict__ ph, const int* __restrict__ pt,
                     const int* __restrict__ pr, const int* __restrict__ pnh,
                     const int* __restrict__ pnt, const bool* __restrict__ valid,
                     float* __restrict__ loss_out,  // []
                     int* __restrict__ viol_out,    // [b]
                     int* __restrict__ trips_out,   // [b, 2] per sample: fired projector trips,
                                                    // projector calls stopped at max_iters
                     int k, int b, int max_iters, float lr, float margin) {
  __shared__ float red[2][4][kMaxWarps];
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
    s.ew = live ? snap_w[(size_t)s.r * k + c] : 0.f;
    s.enh = live ? snap_e[(size_t)s.nh * k + c] : 0.f;
    s.ent = live ? snap_e[(size_t)s.nt * k + c] : 0.f;
    return s;
  };

  // The orthogonality projector norm(a, b, lr) (common/utils.cpp:79-111), as
  // pallas_update.py::_orthogonality_project_value: a test that fails leaves
  // b = b^ of that test; a pair that reaches max_iters keeps its last b.
  auto project = [&](float& a, float& w, int (&trips)[2]) {
    w = sphere(w, sum1(__fmul_rn(w, w)));
    float s = 0.f;
    int it = 0;
    for (; it < max_iters; ++it) {
      const float root = __fsqrt_rn(__fadd_rn(s, sum1(__fmul_rn(w, w))));
      const float scaled = __fdiv_rn(w, root);
      if (!(sum1(__fmul_rn(scaled, a)) > 0.1f)) {  // the same for every thread
        w = scaled;
        break;
      }
      a = __fsub_rn(a, __fmul_rn(lr, scaled));
      w = __fsub_rn(scaled, __fmul_rn(lr, a));
      s = root;
    }
    trips[0] += it;
    trips[1] += it == max_iters;
    w = sphere(w, sum1(__fmul_rn(w, w)));
  };

  // One gradientUpdate (transh/trainer.cpp:11-58) with sign beta on the
  // register rows rw (relation) and ww (normal); x, sx, hs, ts, he and te
  // come from the snapshot.
  auto direction = [&](float& rw, float& ww, int h, int t, float x, float sx, float hs, float ts, float he,
                       float te, float beta, int (&trips)[2]) {
    const bool alias = h == t;
    float hv = live ? ent[(size_t)h * k + c] : 0.f;
    float tv = (live && !alias) ? ent[(size_t)t * k + c] : 0.f;
    const float d = __fmul_rn(-beta * lr, x);
    const float d_t = __fmul_rn(beta * lr, x);
    rw = __fadd_rn(rw, d);
    hv = __fadd_rn(hv, d);
    if (alias) {
      hv = __fadd_rn(hv, d_t);
    } else {
      tv = __fadd_rn(tv, d_t);
    }
    const float dw = __fmul_rn(beta * lr, __fadd_rn(__fmul_rn(x, __fsub_rn(hs, ts)),
                                                    __fmul_rn(sx, __fsub_rn(he, te))));
    ww = __fadd_rn(ww, dw);
    if (alias) {
      float sq[3] = {live ? __fmul_rn(rw, rw) : 0.f, live ? __fmul_rn(hv, hv) : 0.f,
                     live ? __fmul_rn(ww, ww) : 0.f};
      block_sum<3>(sq, red[buf], nwarps);
      buf ^= 1;
      rw = ball(rw, sq[0]);
      hv = ball(hv, sq[1]);
      ww = sphere(ww, sq[2]);
      hv = ball(hv, sum1(__fmul_rn(hv, hv)));
    } else {
      float sq[4] = {live ? __fmul_rn(rw, rw) : 0.f, live ? __fmul_rn(hv, hv) : 0.f,
                     live ? __fmul_rn(tv, tv) : 0.f, live ? __fmul_rn(ww, ww) : 0.f};
      block_sum<4>(sq, red[buf], nwarps);
      buf ^= 1;
      rw = ball(rw, sq[0]);
      hv = ball(hv, sq[1]);
      tv = ball(tv, sq[2]);
      ww = sphere(ww, sq[3]);
    }
    project(rw, ww, trips);
    project(hv, ww, trips);
    project(alias ? hv : tv, ww, trips);
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

    float dots[4] = {__fmul_rn(cur.ew, cur.eh), __fmul_rn(cur.ew, cur.et), __fmul_rn(cur.ew, cur.enh),
                     __fmul_rn(cur.ew, cur.ent)};  // 0 past k
    block_sum<4>(dots, red[buf], nwarps);
    buf ^= 1;
    const float hs_p = dots[0], ts_p = dots[1], hs_n = dots[2], ts_n = dots[3];
    const float rp = __fsub_rn(__fsub_rn(__fsub_rn(cur.et, __fmul_rn(ts_p, cur.ew)),
                                         __fsub_rn(cur.eh, __fmul_rn(hs_p, cur.ew))), cur.er);
    const float rn = __fsub_rn(__fsub_rn(__fsub_rn(cur.ent, __fmul_rn(ts_n, cur.ew)),
                                         __fsub_rn(cur.enh, __fmul_rn(hs_n, cur.ew))), cur.er);
    const float xp = live ? (__fmul_rn(2.f, rp) > 0.f ? 1.f : -1.f) : 0.f;
    const float xn = live ? (__fmul_rn(2.f, rn) > 0.f ? 1.f : -1.f) : 0.f;
    float e[4] = {fabsf(rp), fabsf(rn), __fmul_rn(xp, cur.ew), __fmul_rn(xn, cur.ew)};  // 0 past k
    block_sum<4>(e, red[buf], nwarps);
    buf ^= 1;
    const bool viol = cur.valid && __fadd_rn(e[0], margin) > e[1];
    int trips[2] = {0, 0};  // fired projector trips, projector calls stopped at max_iters
    if (viol) {  // the same for every thread: a uniform branch
      float rw = live ? rel[(size_t)cur.r * k + c] : 0.f;
      float ww = live ? nrm[(size_t)cur.r * k + c] : 0.f;
      direction(rw, ww, cur.h, cur.t, xp, e[2], hs_p, ts_p, cur.eh, cur.et, -1.f, trips);
      direction(rw, ww, cur.nh, cur.nt, xn, e[3], hs_n, ts_n, cur.enh, cur.ent, 1.f, trips);
      if (live) {
        rel[(size_t)cur.r * k + c] = rw;
        nrm[(size_t)cur.r * k + c] = ww;
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

}  // namespace

// Launches one block on `stream` of device `device` and returns
// cudaGetLastError(): 0 when the launch was accepted.
extern "C" int kb2e_transh_update(const float* snap_e, const float* snap_r, const float* snap_w, float* ent,
                                  float* rel, float* nrm, const int* ph, const int* pt, const int* r,
                                  const int* nh, const int* nt, const bool* valid, float* loss, int* viol,
                                  int* trips, int k, int b, int max_iters, int device, float lr, float margin,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxThreads || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (k + 31) / 32 * 32;
  transh_update_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      snap_e, snap_r, snap_w, ent, rel, nrm, ph, pt, r, nh, nt, valid, loss, viol, trips, k, b, max_iters, lr,
      margin);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kb2e_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
