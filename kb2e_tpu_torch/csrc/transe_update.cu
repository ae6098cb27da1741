// Reference-exact sequential TransE update (parity mode), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// kb2e_tpu/ops/pallas_update.py::transe_sequential_update (body _make_kernel,
// "K3").  One batch of the reference's SGD (transe/trainer.cpp:25-56), with
// the result of running the samples one at a time, in order:
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
// 3.35 TB/s) and does a few hundred thousand flops, but the samples that
// share a row form chains of dependent row read-modify-writes, each update
// waiting on one or two block reductions for its norms.
//
// Design, against the TPU kernel's sequential grid with one step per sample
// and row DMAs between HBM and VMEM.  Three launches, as transh_update.cu:
//  1. transe_decide_kernel, one block per sample: the energies, decision and
//     loss term, from the snapshot alone; the energy reduction leaves the
//     chain of dependent samples;
//  2. ordered::loss_kernel, one block: the loss in sample order;
//  3. transe_apply_kernel, a persistent grid of every block that fits on the
//     card at once: the violating samples' updates, side by side where they
//     share no row, each after the earlier samples of its rows (ordered.cuh;
//     the wrapper computes those predecessors between launches 1 and 3).
//     It recomputes x from the snapshot rows, which it loads before the
//     wait on predecessors, so no [B, 2k] scratch goes between the passes.
// Inside one sample, as the single-block kernel it replaced:
//  * thread c owns coordinate c of every row (blockDim = k rounded up to a
//    warp, k <= 1024), so every table read-modify-write is program-ordered
//    inside one thread and the only traffic between threads is the block
//    reductions;
//  * a block reduction sums each warp with shuffles and the warps' partial
//    sums in shared memory in a fixed order, so every thread gets the same
//    bits and takes the same branch; two shared buffers alternate, so one
//    barrier per reduction suffices;
//  * the relation row stays in a register across both directions, as the
//    TPU kernel keeps it in VMEM;
//  * the arithmetic is rounded step by step (the _rn intrinsics keep nvcc
//    from fusing multiply-adds), and the plain PyTorch version
//    (ops/transe_update.py) rounds the same steps and sums over k in this
//    reduction order, so the two agree bit for bit.
// The caller passes the outputs as copies of the snapshot, zeroes *loss and
// the done flags and ticket, and checks that every id lies in its table.

#include <cuda_runtime.h>

#include "ordered.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRows = 5;  // schedule rows a sample lists: h, t, h', t', and its relation

template <int n>
__device__ __forceinline__ void block_sum(float (&v)[n], float (*buf)[kMaxWarps], int nwarps) {
  ordered::block_sum<n, kMaxWarps>(v, buf, nwarps);
}

__device__ __forceinline__ float ball(float v, float sumsq) {
  const float nrm = __fsqrt_rn(sumsq);
  return nrm > 1.f ? __fdiv_rn(v, nrm) : v;
}

__device__ __forceinline__ float grad(bool l1, float res) {
  return l1 ? (__fmul_rn(2.f, res) > 0.f ? 1.f : -1.f) : __fmul_rn(2.f, res);
}

int threads_for(int k) { return (k + 31) / 32 * 32; }

// Launch 1: sample blockIdx.x's energies on the snapshot; writes
// margin + e_p - e_n to terms[i] and the decision.
template <bool kL1>
__global__ void __launch_bounds__(kMaxThreads)
transe_decide_kernel(const float* __restrict__ snap_e,  // [n, k] batch-start snapshot
                     const float* __restrict__ snap_r,  // [R, k]
                     const int* __restrict__ ph, const int* __restrict__ pt,
                     const int* __restrict__ pr, const int* __restrict__ pnh,
                     const int* __restrict__ pnt, const bool* __restrict__ valid,
                     float* __restrict__ terms,  // [b]
                     int* __restrict__ viol_out, int k, float margin) {
  __shared__ float red[2][kMaxWarps];
  const int i = blockIdx.x;
  const int c = threadIdx.x;
  const bool live = c < k;
  const int nwarps = blockDim.x >> 5;
  const float er = live ? snap_r[(size_t)pr[i] * k + c] : 0.f;
  const float rp = live ? __fsub_rn(__fsub_rn(snap_e[(size_t)pt[i] * k + c], snap_e[(size_t)ph[i] * k + c]), er) : 0.f;
  const float rn = live ? __fsub_rn(__fsub_rn(snap_e[(size_t)pnt[i] * k + c], snap_e[(size_t)pnh[i] * k + c]), er) : 0.f;
  float e[2] = {kL1 ? fabsf(rp) : __fmul_rn(rp, rp), kL1 ? fabsf(rn) : __fmul_rn(rn, rn)};  // 0 past k
  block_sum<2>(e, red, nwarps);
  if (c == 0) {
    viol_out[i] = valid[i] && __fadd_rn(e[0], margin) > e[1];
    terms[i] = __fsub_rn(__fadd_rn(margin, e[0]), e[1]);
  }
}

// Launch 3: the violating samples' updates in the reference's per-row order.
__global__ void __launch_bounds__(kMaxThreads, 1)
transe_apply_kernel(const float* __restrict__ snap_e,  // [n, k] batch-start snapshot
                    const float* __restrict__ snap_r,  // [R, k]
                    float* ent,                        // [n, k] output, = snap_e on entry
                    float* rel,                        // [R, k] output, = snap_r on entry
                    const int* __restrict__ ph, const int* __restrict__ pt,
                    const int* __restrict__ pr, const int* __restrict__ pnh,
                    const int* __restrict__ pnt,
                    const int* __restrict__ viol,  // [b] from launch 1
                    const int* __restrict__ pred,  // [b, kRows] latest earlier update of each row, -1: none
                    int* order,                    // [b + 1] zeroed: done flags, then the ticket
                    int k, int b, bool l1, float lr) {
  __shared__ float red[2][3][kMaxWarps];
  __shared__ int slot;
  const int c = threadIdx.x;
  const bool live = c < k;
  const int nwarps = blockDim.x >> 5;
  int buf = 0;  // the reduction buffer to use next

  // One direction of gradientUpdate (transe/trainer.cpp:25-46) with
  // s = -beta lr: r, h += s x; t -= s x; then ball-norm r, h, t.
  auto direction = [&](float& rw, int h, int t, float x, float s) {
    const float d = __fmul_rn(s, x);  // the t delta (-s) x is exactly -d
    const bool alias = h == t;
    float hv = live ? __ldcg(ent + (size_t)h * k + c) : 0.f;
    float tv = (live && !alias) ? __ldcg(ent + (size_t)t * k + c) : 0.f;
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

  int* done = order;
  for (;;) {
    const int i = ordered::next_ticket(order + b, &slot);
    if (i >= b) break;
    if (!viol[i]) continue;  // the same for every thread: a uniform branch
    const int h = ph[i], t = pt[i], r = pr[i], nh = pnh[i], nt = pnt[i];
    // x from the snapshot, which nothing writes: it loads before the wait.
    float xp = 0.f, xn = 0.f;
    if (live) {
      const float er = __ldg(snap_r + (size_t)r * k + c);
      xp = grad(l1, __fsub_rn(__fsub_rn(__ldg(snap_e + (size_t)t * k + c), __ldg(snap_e + (size_t)h * k + c)), er));
      xn = grad(l1, __fsub_rn(__fsub_rn(__ldg(snap_e + (size_t)nt * k + c), __ldg(snap_e + (size_t)nh * k + c)), er));
    }
    ordered::wait_for(done, pred + (size_t)i * kRows, kRows);
    float rw = live ? __ldcg(rel + (size_t)r * k + c) : 0.f;
    direction(rw, h, t, xp, lr);
    direction(rw, nh, nt, xn, -lr);
    if (live) rel[(size_t)r * k + c] = rw;
    ordered::publish(done, i);
  }
}

}  // namespace

// Launches 1 and 2 on `stream` of device `device`: the decisions and the
// loss.  Returns cudaGetLastError(): 0 when both launches were accepted.
extern "C" int kb2e_transe_decide(const float* snap_e, const float* snap_r, const int* ph, const int* pt,
                                  const int* r, const int* nh, const int* nt, const bool* valid, float* terms,
                                  int* viol, float* loss, int k, int b, int l1, int device, float margin,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l1) {
    transe_decide_kernel<true><<<b, threads_for(k), 0, s>>>(snap_e, snap_r, ph, pt, r, nh, nt, valid, terms, viol,
                                                            k, margin);
  } else {
    transe_decide_kernel<false><<<b, threads_for(k), 0, s>>>(snap_e, snap_r, ph, pt, r, nh, nt, valid, terms, viol,
                                                             k, margin);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ordered::loss_kernel<<<1, ordered::kLossThreads, 0, s>>>(viol, terms, loss, b);
  return static_cast<int>(cudaGetLastError());
}

// Launch 3 on `stream` of device `device`, over min(b, resident blocks).
// Returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int kb2e_transe_apply(const float* snap_e, const float* snap_r, float* ent, float* rel, const int* ph,
                                 const int* pt, const int* r, const int* nh, const int* nt, const int* viol,
                                 const int* pred, int* order, int k, int b, int l1, int device, float lr,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = threads_for(k);
  int per_sm = 0, total = 0;
  err = ordered::resident_blocks(transe_apply_kernel, threads, 0, device, &per_sm, &total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = total < b ? total : b;
  transe_apply_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      snap_e, snap_r, ent, rel, ph, pt, r, nh, nt, viol, pred, order, k, b, l1 != 0, lr);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of launch 3 resident on one SM at width k, into *per_sm.
extern "C" int kb2e_transe_blocks_per_sm(int k, int device, int* per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= 0 || k > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  int total = 0;
  return static_cast<int>(ordered::resident_blocks(transe_apply_kernel, threads_for(k), 0, device, per_sm, &total));
}

extern "C" const char* kb2e_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
