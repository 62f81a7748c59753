// K3: exact int64 checksum of the carried usage state (the epoch guard).
//
// Replaces the JAX root kubernetes_tpu/ops/resident.py:451 usage_checksum:
// sum(used) + sum(nz0) + sum(nz1) + sum(num_pods), which the scheduler
// checks against the host-tracked sum after every device batch.
//
// Design: a grid-stride reduction.  Each thread accumulates in int64, each
// block reduces in shared memory, and one atomicAdd per block folds the
// block sums into the result.  Integer addition is exact in any order (two's
// complement wraps identically in the unsigned atomic), so the atomics'
// nondeterministic order cannot change the result.
//
// Bound on the H100: bytes — each of the N * (R + 2) int64 and N int32
// inputs is read once, and the result is one int64.
#include "ktpu.cuh"

namespace {

constexpr int SUM_THREADS = 256;
constexpr int MAX_BLOCKS = 264;  // two per SM is plenty for a few MB

__global__ void __launch_bounds__(SUM_THREADS)
    usage_checksum_kernel(const long long* used, long long n_used,
                          const long long* nz0, const long long* nz1,
                          const int* num_pods, long long n,
                          unsigned long long* out) {
  __shared__ long long part[SUM_THREADS];
  const long long stride = (long long)gridDim.x * SUM_THREADS;
  const long long start = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  long long acc = 0;
  for (long long i = start; i < n_used; i += stride) acc += used[i];
  for (long long i = start; i < n; i += stride)
    acc += nz0[i] + nz1[i] + (long long)num_pods[i];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int w = SUM_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) atomicAdd(out, (unsigned long long)part[0]);
}

}  // namespace

// Zeroes `out` and enqueues K3 on `stream`; returns the launch status.
extern "C" int ktpu_usage_checksum(const long long* used, long long n_used,
                                   const long long* nz0, const long long* nz1,
                                   const int* num_pods, long long n,
                                   long long* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(long long), st);
  if (e != cudaSuccess) return (int)e;
  const long long work = n_used > n ? n_used : n;
  long long blocks = (work + SUM_THREADS - 1) / SUM_THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  usage_checksum_kernel<<<(unsigned)blocks, SUM_THREADS, 0, st>>>(
      used, n_used, nz0, nz1, num_pods, n,
      reinterpret_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
