// K19 tie_bits: the seeded tie-break's bits for a block of attempts.
//
// Replaces jax.random.bits(fold_in(key, attempt), (N,), uint32), which the
// JAX package draws per pod attempt (kubernetes_tpu/ops/gang.py:905-911 in
// the shared step, kubernetes_tpu/scheduler.py:4983-4992 on the one-pod
// host cycle).  out[a, n] = bits(fold_in(key, attempt_base + a))[n] as
// int64, from ktpu::rng::threefry2x32 (csrc/ktpu.cuh), which the shared
// per-pod step calls for the same bits.
//
// Design: one thread per (attempt, node); each folds the attempt into the
// key (20 rounds) and draws its node's word (20 more), with no memory read.
// The function needs one threefry per word and one fold_in per attempt;
// the per-thread fold_in doubles the work, a cost of this design.
//
// Bound on the H100: the int64 writes (8 bytes per output) against the
// integer work.  threefry2x32 is 20 rounds of an add, a rotate (one funnel
// shift) and an xor, and six key injections of two adds (the round constant
// folds into a three-input add): 40 shifts and xors and 32 adds a call, and
// one xor more per word.  Shifts and logic issue only on the 64 INT32 lanes
// of an SM, adds also as IMAD on the FMA pipe, 128 lane operations a clock
// in all (chip_smoke.py tie_bits_bound).
#include "ktpu.cuh"

namespace {

constexpr int RNG_THREADS = 256;

__global__ void __launch_bounds__(RNG_THREADS)
    tie_bits_kernel(unsigned k0, unsigned k1, unsigned attempt_base, int N, long long* out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = blockIdx.y;
  if (n >= N) return;
  unsigned f0 = k0, f1 = k1;
  ktpu::rng::fold_in(f0, f1, attempt_base + (unsigned)a);
  out[(long long)a * N + n] = ktpu::rng::bits_at(f0, f1, (unsigned)n);
}

}  // namespace

// Enqueues K19 on `stream` ([A, N] int64 into `out`) and returns the launch
// status (cudaGetLastError).
extern "C" int ktpu_tie_bits(unsigned k0, unsigned k1, unsigned attempt_base, int A, int N, void* out,
                             void* stream) {
  if (A <= 0 || N <= 0) return 0;
  if (A > 65535) return (int)cudaErrorInvalidConfiguration;  // gridDim.y
  const dim3 grid((N + RNG_THREADS - 1) / RNG_THREADS, A);
  tie_bits_kernel<<<grid, RNG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(k0, k1, attempt_base, N,
                                                                              static_cast<long long*>(out));
  return (int)cudaGetLastError();
}
