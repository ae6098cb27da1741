// Reference-exact sequential TransH update (parity mode), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// kb2e_tpu/ops/pallas_update.py::transh_sequential_update (body
// _make_transh_kernel, projector _orthogonality_project_value, "K4").  One
// batch of the reference's SGD (transh/trainer.cpp:11-58), with the result of
// running the samples one at a time, in order.  With w the relation's
// hyperplane normal, on the batch-start snapshot:
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
// each violating sample waits on about twenty-five dependent block
// reductions (per direction one for the norms and at least four per
// projector call) and on the earlier samples that share one of its rows.
//
// Design, against the TPU kernel's sequential grid with one step per sample
// and row DMAs between HBM and VMEM.  Three launches:
//  1. transh_decide_kernel, one block per sample: the w-dots, energies,
//     decision, loss term, x and sum_x, from the snapshot alone, into
//     scratch; two of each sample's dependent block reductions leave the
//     chain of dependent samples;
//  2. ordered::loss_kernel, one block: the loss in sample order;
//  3. transh_apply_kernel, a persistent grid of every block that fits on the
//     card at once: the violating samples' updates, side by side where they
//     share no row, each after the earlier samples of its rows (ordered.cuh;
//     the wrapper computes those predecessors between launches 1 and 3).
// Inside one sample, as the single-block kernel it replaced:
//  * thread c owns coordinate c of every row (blockDim = k rounded up to a
//    warp, k <= 1024), so every table read-modify-write is program-ordered
//    inside one thread and the only traffic between threads is the block
//    reductions;
//  * a block reduction sums each warp with shuffles and the warps' partial
//    sums in shared memory in a fixed order, so every thread gets the same
//    bits and takes the same branch (the decision, the ball norms, every
//    projector test); two shared buffers alternate, so one barrier per
//    reduction suffices;
//  * the relation row r and the normal w stay in registers across both
//    directions, as the TPU kernel keeps them in VMEM slots 0 and 1; the
//    snapshot coordinates and the decide pass's values load before the wait
//    on predecessors;
//  * the arithmetic is rounded step by step (the _rn intrinsics keep nvcc
//    from fusing multiply-adds), and the plain PyTorch version
//    (ops/transh_update.py) rounds the same steps and sums over k in this
//    reduction order, so the two agree bit for bit.
// The caller passes the outputs as copies of the snapshot, zeroes *loss and
// the done flags and ticket, and checks that every id lies in its table.

#include <cuda_runtime.h>

#include "ordered.cuh"

namespace {

using ordered::sphere;

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRows = 5;  // schedule rows a sample lists: h, t, h', t', and its relation (r and w)
// Scratch a sample: x_p [k], x_n [k], then hs_p, ts_p, hs_n, ts_n, sum_x_p, sum_x_n.
constexpr int kScalars = 6;

template <int n>
__device__ __forceinline__ void block_sum(float (&v)[n], float (*buf)[kMaxWarps], int nwarps) {
  ordered::block_sum<n, kMaxWarps>(v, buf, nwarps);
}

__device__ __forceinline__ float ball(float v, float sumsq) {
  const float nrm = __fsqrt_rn(sumsq);
  return nrm > 1.f ? __fdiv_rn(v, nrm) : v;
}

int threads_for(int k) { return (k + 31) / 32 * 32; }

// Launch 1: sample blockIdx.x's energies on the snapshot; writes its scratch
// row, margin + e_p - e_n to terms[i], and the decision.
__global__ void __launch_bounds__(kMaxThreads)
transh_decide_kernel(const float* __restrict__ snap_e,  // [n, k] batch-start snapshot
                     const float* __restrict__ snap_r,  // [R, k]
                     const float* __restrict__ snap_w,  // [R, k]
                     const int* __restrict__ ph, const int* __restrict__ pt,
                     const int* __restrict__ pr, const int* __restrict__ pnh,
                     const int* __restrict__ pnt, const bool* __restrict__ valid,
                     float* __restrict__ xs,     // [b, 2k + kScalars]
                     float* __restrict__ terms,  // [b]
                     int* __restrict__ viol_out, int k, float margin) {
  __shared__ float red[2][4][kMaxWarps];
  const int i = blockIdx.x;
  const int c = threadIdx.x;
  const bool live = c < k;
  const int nwarps = blockDim.x >> 5;
  const int r = pr[i];
  // This thread's coordinate of the snapshot rows h, t, r, w, h', t'.
  const float eh = live ? snap_e[(size_t)ph[i] * k + c] : 0.f;
  const float et = live ? snap_e[(size_t)pt[i] * k + c] : 0.f;
  const float er = live ? snap_r[(size_t)r * k + c] : 0.f;
  const float ew = live ? snap_w[(size_t)r * k + c] : 0.f;
  const float enh = live ? snap_e[(size_t)pnh[i] * k + c] : 0.f;
  const float ent = live ? snap_e[(size_t)pnt[i] * k + c] : 0.f;

  float dots[4] = {__fmul_rn(ew, eh), __fmul_rn(ew, et), __fmul_rn(ew, enh), __fmul_rn(ew, ent)};  // 0 past k
  block_sum<4>(dots, red[0], nwarps);
  const float hs_p = dots[0], ts_p = dots[1], hs_n = dots[2], ts_n = dots[3];
  const float rp = __fsub_rn(__fsub_rn(__fsub_rn(et, __fmul_rn(ts_p, ew)), __fsub_rn(eh, __fmul_rn(hs_p, ew))), er);
  const float rn = __fsub_rn(__fsub_rn(__fsub_rn(ent, __fmul_rn(ts_n, ew)), __fsub_rn(enh, __fmul_rn(hs_n, ew))), er);
  const float xp = live ? (__fmul_rn(2.f, rp) > 0.f ? 1.f : -1.f) : 0.f;
  const float xn = live ? (__fmul_rn(2.f, rn) > 0.f ? 1.f : -1.f) : 0.f;
  float e[4] = {fabsf(rp), fabsf(rn), __fmul_rn(xp, ew), __fmul_rn(xn, ew)};  // 0 past k
  block_sum<4>(e, red[1], nwarps);
  float* row = xs + (size_t)i * (2 * k + kScalars);
  if (live) {
    row[c] = xp;
    row[k + c] = xn;
  }
  if (c == 0) {
    row[2 * k] = hs_p;
    row[2 * k + 1] = ts_p;
    row[2 * k + 2] = hs_n;
    row[2 * k + 3] = ts_n;
    row[2 * k + 4] = e[2];
    row[2 * k + 5] = e[3];
    viol_out[i] = valid[i] && __fadd_rn(e[0], margin) > e[1];
    terms[i] = __fsub_rn(__fadd_rn(margin, e[0]), e[1]);
  }
}

// Launch 3: the violating samples' updates in the reference's per-row order.
__global__ void __launch_bounds__(kMaxThreads, 1)
transh_apply_kernel(const float* __restrict__ snap_e,  // [n, k] batch-start snapshot
                    float* ent,                        // [n, k] output, = snap_e on entry
                    float* rel,                        // [R, k] output, = snap_r on entry
                    float* nrm,                        // [R, k] output, = snap_w on entry
                    const int* __restrict__ ph, const int* __restrict__ pt,
                    const int* __restrict__ pr, const int* __restrict__ pnh,
                    const int* __restrict__ pnt,
                    const int* __restrict__ viol,  // [b] from launch 1
                    const float* __restrict__ xs,  // [b, 2k + kScalars] from launch 1
                    const int* __restrict__ pred,  // [b, kRows] latest earlier update of each row, -1: none
                    int* order,                    // [b + 1] zeroed: done flags, then the ticket
                    int* __restrict__ trips_out,   // [b, 2] per sample: fired projector trips,
                                                   // projector calls stopped at max_iters
                    int k, int b, int max_iters, float lr) {
  __shared__ float red[2][4][kMaxWarps];
  __shared__ int slot;
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
    float hv = live ? __ldcg(ent + (size_t)h * k + c) : 0.f;
    float tv = (live && !alias) ? __ldcg(ent + (size_t)t * k + c) : 0.f;
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

  int* done = order;
  for (;;) {
    const int i = ordered::next_ticket(order + b, &slot);
    if (i >= b) break;
    int trips[2] = {0, 0};  // fired projector trips, projector calls stopped at max_iters
    if (viol[i]) {          // the same for every thread: a uniform branch
      const int h = ph[i], t = pt[i], r = pr[i], nh = pnh[i], nt = pnt[i];
      // The snapshot and the decide pass's values: nothing writes them, so
      // they load before the wait.
      const float eh = live ? __ldg(snap_e + (size_t)h * k + c) : 0.f;
      const float et = live ? __ldg(snap_e + (size_t)t * k + c) : 0.f;
      const float enh = live ? __ldg(snap_e + (size_t)nh * k + c) : 0.f;
      const float ent_ = live ? __ldg(snap_e + (size_t)nt * k + c) : 0.f;
      const float* row = xs + (size_t)i * (2 * k + kScalars);
      const float xp = live ? __ldg(row + c) : 0.f;
      const float xn = live ? __ldg(row + k + c) : 0.f;
      const float hs_p = __ldg(row + 2 * k), ts_p = __ldg(row + 2 * k + 1);
      const float hs_n = __ldg(row + 2 * k + 2), ts_n = __ldg(row + 2 * k + 3);
      const float sx_p = __ldg(row + 2 * k + 4), sx_n = __ldg(row + 2 * k + 5);
      ordered::wait_for(done, pred + (size_t)i * kRows, kRows);
      float rw = live ? __ldcg(rel + (size_t)r * k + c) : 0.f;
      float ww = live ? __ldcg(nrm + (size_t)r * k + c) : 0.f;
      direction(rw, ww, h, t, xp, sx_p, hs_p, ts_p, eh, et, -1.f, trips);
      direction(rw, ww, nh, nt, xn, sx_n, hs_n, ts_n, enh, ent_, 1.f, trips);
      if (live) {
        rel[(size_t)r * k + c] = rw;
        nrm[(size_t)r * k + c] = ww;
      }
      ordered::publish(done, i);
    }
    if (c == 0) {
      trips_out[2 * i] = trips[0];
      trips_out[2 * i + 1] = trips[1];
    }
  }
}

}  // namespace

// Launches 1 and 2 on `stream` of device `device`: the decisions, the
// scratch rows and the loss.  Returns cudaGetLastError(): 0 when both
// launches were accepted.
extern "C" int kb2e_transh_decide(const float* snap_e, const float* snap_r, const float* snap_w, const int* ph,
                                  const int* pt, const int* r, const int* nh, const int* nt, const bool* valid,
                                  float* xs, float* terms, int* viol, float* loss, int k, int b, int device,
                                  float margin, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  transh_decide_kernel<<<b, threads_for(k), 0, s>>>(snap_e, snap_r, snap_w, ph, pt, r, nh, nt, valid, xs, terms,
                                                    viol, k, margin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ordered::loss_kernel<<<1, ordered::kLossThreads, 0, s>>>(viol, terms, loss, b);
  return static_cast<int>(cudaGetLastError());
}

// Launch 3 on `stream` of device `device`, over min(b, resident blocks).
// Returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int kb2e_transh_apply(const float* snap_e, float* ent, float* rel, float* nrm, const int* ph,
                                 const int* pt, const int* r, const int* nh, const int* nt, const int* viol,
                                 const float* xs, const int* pred, int* order, int* trips, int k, int b,
                                 int max_iters, int device, float lr, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxThreads || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = threads_for(k);
  int per_sm = 0, total = 0;
  err = ordered::resident_blocks(transh_apply_kernel, threads, 0, device, &per_sm, &total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = total < b ? total : b;
  transh_apply_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      snap_e, ent, rel, nrm, ph, pt, r, nh, nt, viol, xs, pred, order, trips, k, b, max_iters, lr);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of launch 3 resident on one SM at width k, into *per_sm.
extern "C" int kb2e_transh_blocks_per_sm(int k, int device, int* per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= 0 || k > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  int total = 0;
  return static_cast<int>(ordered::resident_blocks(transh_apply_kernel, threads_for(k), 0, device, per_sm, &total));
}

extern "C" const char* kb2e_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
