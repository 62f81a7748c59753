// K11 workloads_admit: the gang admission pass of the workloads dispatch,
// one launch per batch.
//
// Replaces the JAX root kubernetes_tpu/ops/coscheduling.py:140
// workloads_schedule, its admission pass (a lax.scan over the term-factored
// carries with the gang checkpoint and, for a batch with DRA claims, the
// allocation carries, :297-432); the speculation pass (:287-295) is the
// wave's, so it is K8 (csrc/wave.cu) with K14's DRA lane (csrc/dra.cu).  The
// recurrence is K9's: K11 is ktpu::wave::admit_cluster_kernel<true>
// (csrc/ktpu.cuh), the kernel K9 launches, on the same plan (admit_plan: one
// thread-block cluster of 16 CTAs, 8 where the card admits no cluster of
// 16, each over a slice of the nodes with its usage rows, carry columns,
// node statics and staged planes in shared memory while they fit; see
// csrc/wave.cu), running ktpu::wave::admit_loop<true> under
// ktpu::step::ClusterPolicy: over the pods in plan_batch order, each step
// ktpu::step::pod_step_block with the peers' counts read from the carries.
// No host ports reach it (the workloads gate refuses them), so Tpt = 0, and
// no demotion is attributed.
//
// The gangs: at a gang's last member, when the members placed in the batch
// (`landed`, reset at the first member) are fewer than gang_need, the gang
// rolls back by undo, not by copy.  The reference keeps one checkpoint,
// taken before the most recent first member's step (the initial state
// before any), and every commit since is additive: the usage (request,
// nonzero, one pod), one term column per matching term, and the pod's own
// terms over their domains in rev_cnt.  So the rollback subtracts the
// commits of the pods from that point, or from the pod after the last
// rollback, through the failing member, each from its recorded choice
// (every CTA keeps a row of the batch's choices): the CTA that owns the
// chosen node undoes the usage and the columns there, every CTA undoes
// rev_cnt over its slice, the split of the commit; their `assigned` read
// -1 again (ktpu::wave::undo_gang).  This is exact for any gang layout:
// overlapping gangs, a last member before any first, pad rows.  Each step's
// choice before any rollback goes to GangScanArgs.chosen (the `raw`
// output).
//
// DRA mode (WorkloadsArgs.dra_match not null; ops/dra.py): per pod every
// CTA computes the pod's verdict at the nodes of its slice against the
// carries free [N, DD] (whose rows belong to the CTA that owns the node)
// and its own copy of claim_node [CL] (shared memory where it fits) into
// dra_row (ktpu::dra::node_verdict_any, K14's device code), which the step
// reads as its port lane (WaveDyn::portb), so a DRA rejection lands in the
// NodePorts diagnosis lane as in the reference.  After the step the CTA
// that owns the chosen node takes the pod's devices there and logs them
// (take_log), and every CTA pins in its copy each claim the pod references
// that is still unallocated, noting the pod as its pinner; a rollback
// frees the logged devices and unpins what the undone pods pinned.  Past
// dra::REG_DD devices each thread's verdict words sit in a scratch row.
//
// Bound on the H100: the recurrence, as K9 (per pod four exchanges across
// the cluster and a pass over a slice of N / G nodes per step phase); a
// rollback costs the commits it undoes, one pass over the slice per undone
// pod for rev_cnt.
#include "ktpu.cuh"

using namespace ktpu::wave;

// K11's launch plan into `wave` and `gangs` (ktpu::wave::admit_plan, as
// K9's): the cluster size under cluster_cap, the slice and what sits in
// shared memory under smem_cap (with claims, the CTAs' claim copies last);
// the pods' planes staged only with `stage`.  Returns a CUDA status.
extern "C" int ktpu_workloads_admit_plan(const GangScanArgs* args, WaveArgs* wave, WorkloadsArgs* gangs,
                                         int cluster_cap, int smem_cap, int stage) {
  return admit_plan<true>(*args, *wave, *gangs, cluster_cap, smem_cap, stage);
}

// Enqueues K11 (one cluster, as ktpu_workloads_admit_plan laid it out) on
// `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_workloads_admit(const GangScanArgs* args, const WaveArgs* wave, const WorkloadsArgs* gangs,
                                    void* stream) {
  return admit_launch<true>(*args, *wave, *gangs, stream);
}

// The threads of one CTA of the cluster: WorkloadsArgs.dra_scratch has a
// row per thread of the cluster.
extern "C" int ktpu_cluster_threads() { return ktpu::step::CLUSTER_THREADS; }
