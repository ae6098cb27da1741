// Reference-exact sequential TransE update (parity mode), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// kb2e_tpu/ops/pallas_update.py::transe_sequential_update (body _make_kernel,
// "K3").  One batch of the reference's SGD (transe/trainer.cpp:25-56), one
// sample at a time, in order:
//   e_p = dist(t - h - r), e_n = dist(t' - h' - r) on the batch-start snapshot;
//   if valid and e_p + margin > e_n:
//     loss += margin + e_p - e_n;
//     r, h += lr x_p;  t -= lr x_p;   ball-norm r, h, t (in that order);
//     r, h' -= lr x_n; t' += lr x_n;  ball-norm r, h', t';
// with x = 2 res (L2) or +1 where 2 res > 0, else -1 (L1), res taken on the
// snapshot, and every update read-modify-writing the output tables, so a
// sample sees the rows every earlier sample wrote.  When h == t both deltas
// land on the one row before any norm, and that row is ball-normed twice,
// the second norm reading the first's result (pallas_update.py:142,159-163).
//
// Bound on an H100: latency, not bytes or operations.  A launch must move
// the two tables in and out once (13 MB at FB15k, k = 100: about 4 us at
// 3.35 TB/s) and does a few hundred thousand flops, but the samples form a
// chain of dependent row read-modify-writes: each violating sample waits on
// two or three block reductions (energies, then the norms of each direction)
// and on reads of rows an earlier sample may have written.
//
// Design, against the TPU kernel's sequential grid with one step per sample
// and row DMAs between HBM and VMEM:
//  * one block walks the B samples in order; thread c owns coordinate c of
//    every row (blockDim = k rounded up to a warp, k <= 1024), so every
//    table read-modify-write is program-ordered inside one thread and the
//    only traffic between threads is the block reductions;
//  * a block reduction sums each warp with shuffles and the warps' partial
//    sums in shared memory in a fixed order, so every thread gets the same
//    bits and takes the same branch; two shared buffers alternate, so one
//    barrier per reduction suffices;
//  * the energies read the snapshot, which nothing writes: the next
//    sample's indices and snapshot coordinates are loaded while the current
//    sample is processed;
//  * the relation row stays in a register across both directions, as the
//    TPU kernel keeps it in VMEM;
//  * the arithmetic is rounded step by step (the _rn intrinsics keep nvcc
//    from fusing multiply-adds), as the plain PyTorch version rounds it;
//    only the order of the sums over k differs.
// The caller passes the outputs as copies of the snapshot, zeroes *loss, and
// checks that every id lies in its table.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;

struct Sample {
  int h, t, r, nh, nt;
  bool valid;
  float eh, et, er, enh, ent;  // this thread's coordinate of the snapshot rows
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

template <bool kL1>
__device__ __forceinline__ float grad(float res) {
  return kL1 ? (__fmul_rn(2.f, res) > 0.f ? 1.f : -1.f) : __fmul_rn(2.f, res);
}

template <bool kL1>
__global__ void __launch_bounds__(kMaxThreads, 1)
transe_update_kernel(const float* __restrict__ snap_e,  // [n, k] batch-start snapshot
                     const float* __restrict__ snap_r,  // [R, k]
                     float* __restrict__ ent,           // [n, k] output, = snap_e on entry
                     float* __restrict__ rel,           // [R, k] output, = snap_r on entry
                     const int* __restrict__ ph, const int* __restrict__ pt,
                     const int* __restrict__ pr, const int* __restrict__ pnh,
                     const int* __restrict__ pnt, const bool* __restrict__ valid,
                     float* __restrict__ loss_out,  // []
                     int* __restrict__ viol_out,    // [b]
                     int k, int b, float lr, float margin) {
  __shared__ float red[2][3][kMaxWarps];
  const int c = threadIdx.x;
  const bool live = c < k;
  const int nwarps = blockDim.x >> 5;
  int buf = 0;  // the reduction buffer to use next

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

  // One direction of gradientUpdate (transe/trainer.cpp:25-46) with
  // s = -beta lr: r, h += s x; t -= s x; then ball-norm r, h, t.
  auto direction = [&](float& rw, int h, int t, float x, float s) {
    const float d = __fmul_rn(s, x);  // the t delta (-s) x is exactly -d
    const bool alias = h == t;
    float hv = live ? ent[(size_t)h * k + c] : 0.f;
    float tv = (live && !alias) ? ent[(size_t)t * k + c] : 0.f;
    rw = __fadd_rn(rw, d);
    hv = __fadd_rn(hv, d);
    if (alias) {
      hv = __fadd_rn(hv, -d);
    } else {
      tv = __fadd_rn(tv, -d);
    }
    // Threads past k hold no coordinate: they add 0 to every sum.
    float sq[3] = {live ? __fmul_rn(rw, rw) : 0.f, live ? __fmul_rn(hv, hv) : 0.f,
                   live ? __fmul_rn(tv, tv) : 0.f};
    block_sum<3>(sq, red[buf], nwarps);
    buf ^= 1;
    rw = ball(rw, sq[0]);
    hv = ball(hv, sq[1]);
    if (alias) {
      float sq2[1] = {live ? __fmul_rn(hv, hv) : 0.f};
      block_sum<1>(sq2, red[buf], nwarps);
      buf ^= 1;
      hv = ball(hv, sq2[0]);
    } else {
      tv = ball(tv, sq[2]);
    }
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

    const float rp = __fsub_rn(__fsub_rn(cur.et, cur.eh), cur.er);
    const float rn = __fsub_rn(__fsub_rn(cur.ent, cur.enh), cur.er);
    float e[2] = {kL1 ? fabsf(rp) : __fmul_rn(rp, rp), kL1 ? fabsf(rn) : __fmul_rn(rn, rn)};  // 0 past k
    block_sum<2>(e, red[buf], nwarps);
    buf ^= 1;
    const bool viol = cur.valid && __fadd_rn(e[0], margin) > e[1];
    if (c == 0) {
      viol_out[i] = viol;
      if (viol) loss = __fadd_rn(loss, __fsub_rn(__fadd_rn(margin, e[0]), e[1]));
    }
    if (viol) {  // the same for every thread: a uniform branch
      float rw = live ? rel[(size_t)cur.r * k + c] : 0.f;
      direction(rw, cur.h, cur.t, grad<kL1>(rp), lr);
      direction(rw, cur.nh, cur.nt, grad<kL1>(rn), -lr);
      if (live) rel[(size_t)cur.r * k + c] = rw;
    }
    cur = nxt;
  }
  if (c == 0) *loss_out = loss;
}

}  // namespace

// Launches one block on `stream` of device `device` and returns
// cudaGetLastError(): 0 when the launch was accepted.
extern "C" int kb2e_transe_update(const float* snap_e, const float* snap_r, float* ent, float* rel,
                                  const int* ph, const int* pt, const int* r, const int* nh,
                                  const int* nt, const bool* valid, float* loss, int* viol,
                                  int k, int b, int l1, int device, float lr, float margin,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (k + 31) / 32 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l1) {
    transe_update_kernel<true><<<1, threads, 0, s>>>(snap_e, snap_r, ent, rel, ph, pt, r, nh, nt,
                                                     valid, loss, viol, k, b, lr, margin);
  } else {
    transe_update_kernel<false><<<1, threads, 0, s>>>(snap_e, snap_r, ent, rel, ph, pt, r, nh, nt,
                                                      valid, loss, viol, k, b, lr, margin);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kb2e_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
