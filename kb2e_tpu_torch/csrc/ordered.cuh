// What the sequential-update kernels of transe_update.cu, transh_update.cu
// and transr_update.cu share: the block reduction each sample's arithmetic
// is built on, and the schedule that runs independent samples side by side
// in the reference's per-row order.
//
// The schedule.  A sample reads and writes only its own rows of the output
// tables (h, t, h', t', and its relation's rows), so two samples that share
// no row commute exactly, and any order that keeps, for every row, the
// samples that touch it in batch order gives the sequential result bit for
// bit.  ops/schedule.py::row_predecessors lists, for each update, the
// latest earlier update of each of its rows (-1 for none).  A persistent
// grid of resident blocks then walks the batch:
//  * a block takes the next sample with one atomicAdd on a ticket counter,
//    so samples are taken in increasing order by blocks that are already
//    running: the earliest unfinished sample is always running, and its
//    predecessors are done, so the grid cannot deadlock, whatever its size;
//  * before its first read of an output table, thread 0 waits, with an
//    acquire load at device scope and a short __nanosleep back-off, until
//    each predecessor has published;
//  * after its last write, the block publishes: a barrier, then thread 0
//    fences and stores its done flag with release semantics.
// The output tables are read with __ldcg (L2, not a possibly stale L1 line
// of this SM): another SM may have written them since the launch.

#pragma once

#include <cuda_runtime.h>

namespace ordered {

// Sums each of v[0..n) over the block; every thread gets the same sums.
// Each warp halves with shuffles, then the warps' sums are added in order
// (ops/transh_update.py::kernel_order_sum).
template <int n, int kMaxWarps>
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

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The block's next sample: ticket counter at *ticket, broadcast through
// the shared *slot.
__device__ __forceinline__ int next_ticket(int* ticket, int* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(ticket, 1);
  __syncthreads();
  const int i = *slot;
  __syncthreads();  // every thread has read the slot before thread 0 writes it again
  return i;
}

// Waits until every predecessor in pred[0..m) (-1: none) has published.  A
// wait is at most the resident blocks' samples ahead of this one (tens of
// ms); one that polls 2^24 times (seconds) traps, so a broken schedule
// fails the launch instead of hanging the card.
__device__ __forceinline__ void wait_for(const int* done, const int* __restrict__ pred, int m) {
  if (threadIdx.x == 0) {
    for (int j = 0; j < m; ++j) {
      const int p = pred[j];
      if (p < 0) continue;
      unsigned ns = 8, polls = 0;
      while (load_acquire(done + p) == 0) {
        if (++polls == (1u << 24)) __trap();
        __nanosleep(ns);
        if (ns < 256) ns *= 2;
      }
    }
  }
  __syncthreads();
}

// Marks sample i done once every thread's writes are visible device-wide.
__device__ __forceinline__ void publish(int* done, int i) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    store_release(done + i, 1);
  }
}

constexpr int kLossThreads = 256;

// The loss: thread 0 adds the violating samples' terms margin + e_p - e_n
// in sample order, as the sequential loop adds them.  The block stages each
// chunk of decisions and terms in shared memory, so that thread's loads
// come from there and not one by one from device memory.
__global__ void __launch_bounds__(kLossThreads)
loss_kernel(const int* __restrict__ viol, const float* __restrict__ terms, float* __restrict__ loss, int b) {
  __shared__ float term[kLossThreads];
  __shared__ int counted[kLossThreads];
  float s = 0.f;
  for (int base = 0; base < b; base += kLossThreads) {
    const int i = base + threadIdx.x;
    counted[threadIdx.x] = i < b ? viol[i] : 0;
    term[threadIdx.x] = i < b ? terms[i] : 0.f;
    __syncthreads();
    if (threadIdx.x == 0) {
      const int n = b - base < kLossThreads ? b - base : kLossThreads;
#pragma unroll 8
      for (int j = 0; j < n; ++j) s = counted[j] ? __fadd_rn(s, term[j]) : s;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *loss = s;
}

// Blocks of `kernel` resident at once on the device: SMs x blocks per SM.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int device, int* per_sm, int* total) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (*per_sm <= 0) return cudaErrorInvalidConfiguration;
  *total = sms * *per_sm;
  return cudaSuccess;
}

}  // namespace ordered
