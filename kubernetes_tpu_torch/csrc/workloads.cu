// K11 workloads_admit: the gang admission pass of the workloads dispatch,
// one launch per batch.
//
// Replaces the JAX root kubernetes_tpu/ops/coscheduling.py:140
// workloads_schedule, its admission pass (a lax.scan over the term-factored
// carries with the gang checkpoint and, for a batch with DRA claims, the
// allocation carries, :297-432); the speculation pass (:287-295) is the
// wave's, so it is K8 (csrc/wave.cu) with K14's DRA lane (csrc/dra.cu).  The recurrence is K9's: K11 is
// ktpu::wave::admit_kernel<true> (csrc/ktpu.cuh), one persistent block of
// 1024 threads that runs ktpu::wave::admit_loop, the loop K9 runs on a
// thread-block cluster, here with ktpu::step::BlockPolicy: over the pods in
// plan_batch order, each step ktpu::step::pod_step_block with the peers'
// counts read from the carries.
// No host ports reach it (the workloads gate refuses them), so Tpt = 0, and
// no demotion is attributed.
//
// The gangs: at a gang's first member (gang_first, gang_id >= 0) the block
// copies the whole carried state into a global checkpoint before the step:
//   requested [N, Rn], nonzero [N, 2], num_pods [N]   (the usage rows)
//   assigned [P]                                      (the choices so far)
//   cnt_sp [Tsp, N], cnt_ip [Tip, N], rev_cnt [Tip, N] (the carries, in
//                                                      shared or global memory)
// and at its last member, when the members placed in the batch (`landed`,
// reset at the first member) are fewer than gang_need, copies it back, so
// later pods see a state in which the gang never happened.  The checkpoint
// starts as the initial state, as the reference's carry does; the block
// copies that state only when a gang's last member comes before every first
// member (plan_batch never lays a batch out so).  Each step's choice before
// any rollback goes to GangScanArgs.chosen (the `raw` output); `assigned`
// is the choice after rollback.  Every copy sits between two barriers: the
// usage rows are committed by thread 0, the carries by many threads.
//
// DRA mode (WorkloadsArgs.dra_match not null; ops/dra.py): per pod the block
// first computes the pod's verdict at every node against the carries
// free [N, DD] and claim_node [CL] into the dra_row scratch
// (ktpu::dra::node_verdict, K14's device code), which the step reads as its
// port lane (WaveDyn::portb), so a DRA rejection lands in the NodePorts
// diagnosis lane as in the reference.  After the step, thread 0 computes
// the pod's take row at the chosen node only, clears it from `free`, and
// pins every claim the pod references that is still unallocated to the
// node.  The checkpoint then also covers claim_node's CL ints and free's
// N DD bytes.
//
// Bound on the H100: the recurrence, as K5 (one SM of 132; ~6 block
// reductions and their barriers per pod); the checkpoint adds one
// block-wide copy of ((Rn + 3 + Tsp + 2 Tip) N + P) int32s per gang, and a
// second per gang that rolls back.  Rolling back by an undo log of the
// members' rank-1 commits would copy less; that is a later change.
#include "ktpu.cuh"

using namespace ktpu::wave;

// The dynamic shared memory one K11 block may take on this device.
extern "C" int ktpu_workloads_admit_smem_max() { return admit_smem_max<true>(); }

// The threads of one K11 block: the rows of WorkloadsArgs.dra_scratch.
extern "C" int ktpu_admit_threads() { return ADMIT_THREADS; }

// Enqueues K11 on `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_workloads_admit(const GangScanArgs* args, const WaveArgs* wave, const WorkloadsArgs* gangs,
                                    void* stream) {
  return admit_launch<true>(*args, *wave, *gangs, stream);
}
