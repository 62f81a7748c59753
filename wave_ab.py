"""Times the workloads engine's kernels of one checkout on the card: K8
(wave_speculate) on the plain statics laid out two ways, K5, K9 and K11
on the contiguous ones, and the precompute's K6 (gang_spread_statics) and
K7 (gang_interpod_statics).

The shapes are chip_smoke.py's wave rows: config4 and config3
(gang_shapes), ports and mixed (wave_shapes), and gang_mixed (gang_shapes'
mixed batch, with host ports: K6's and K7's mixed row), each a batch of 512
pods.
The statics are the plain precompute's (gang.precompute_plain without
ports), as chip_smoke.py's wave checks make them.  K8 is timed

  k8_as_returned  on the statics as precompute_plain returns them (a field
                  that is a strided view is copied to contiguous rows by
                  K8's wrapper, inside the timed call);
  k8_contiguous   on the statics copied to contiguous rows first (the
                  wrapper's copy is then a no-op);
  copy            the copy alone (every field, .contiguous()).

K9 runs on K8's choices, K5 on the same statics (not on the port-contended
shape), K11 with gangs of 8 of which every fourth needs 9 (it rolls back).
K6 is timed where the batch has spread constraints, K7 whole (inter-pod
and ports) and its placed terms alone (the pods' own terms cut away, ports
off: chip_smoke.without_own_terms) where it has inter-pod terms, and K7's
ports-only launch (what every config4 batch makes) on every shape; each
through the wrappers both sides have (spread_statics, interpod_statics),
with a digest of their outputs and, where the checkout records them, each
kernel's span (gang.statics_spans).

    python3 wave_ab.py [ROOT] [--reps N] [--shapes config4,ports]

ROOT (default: this script's directory) is the checkout whose port and
chip_smoke.py are imported.  To compare two commits on one machine, unpack
both and run this script once per checkout, in turns (A, B, B, A): each
process builds its checkout's kernels into that checkout.  Prints one JSON
line: the checkout, the card's name and power limit, and per shape the
strided fields with their bytes, each time in ms (CUDA events, the mean of
N calls, chip_smoke.time_ms), K8's groups' span in us where the checkout
records it (wave.spec_stats), and a digest of K8's choices (equal digests,
equal answers).
"""

import argparse
import hashlib
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", default="config4,config3,gang_mixed,ports,mixed", help="comma-separated shape names")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import coscheduling as cos
    from kubernetes_tpu_torch.ops import fastpath as ops_fp
    from kubernetes_tpu_torch.ops import gang, wave

    _build.load()
    dev = torch.device("cuda")
    reps = args.reps
    out = dict(root=root, card=cs.card_line(), reps=reps)
    shapes = args.shapes.split(",")
    gs = cs.gang_shapes()
    for name, nodes, placed, pending in gs[:2] + [("gang_mixed", *gs[2][1:])] + cs.wave_shapes():
        if name not in shapes:
            continue
        dc, db, kw, d_cap, flags, wt = cs.wave_inputs(torch, dev, nodes, placed, pending)
        hk, v_cap = kw["hostname_key"], kw["v_cap"]
        tab = {k: kw[k] for k in ("sp_keys", "sp_cdv_tab", "ip_keys")}
        g0 = gang.precompute_plain(dc, db, hk, v_cap, hard_pod_affinity_weight=1, enabled=gang.ALL_FILTER_KERNELS,
                                   **dict(flags, has_ports=False), **tab)
        g = gang.GangStatics(*(t.contiguous() for t in g0))
        strided = {f: getattr(g0, f).numel() * getattr(g0, f).element_size()
                   for f in g0._fields if not getattr(g0, f).is_contiguous()}
        targs = [wt[k] for k in cs.WAVE_TABLES]
        tkw = dict(d_cap=d_cap, d2_cap=wt["d2_cap"], has_ports=wt["has_ports"], tid_pt=wt["tid_pt"],
                   port_conf=wt["port_conf"])
        c0 = wave.wave_speculate(dc, db, g, d_cap=d_cap)
        c0_strided = wave.wave_speculate(dc, db, g0, d_cap=d_cap)
        torch.cuda.synchronize()
        if not torch.equal(c0, c0_strided):
            raise AssertionError(f"{name}: K8 differs between the two layouts")
        r = dict(strided_bytes=strided,
                 k8_choices_sha256=hashlib.sha256(c0.cpu().numpy().tobytes()).hexdigest()[:16])
        r["k8_as_returned"] = cs.time_ms(torch, lambda: wave.wave_speculate(dc, db, g0, d_cap=d_cap), reps)
        r["k8_contiguous"] = cs.time_ms(torch, lambda: wave.wave_speculate(dc, db, g, d_cap=d_cap), reps)
        if "info" in getattr(wave, "spec_stats", {}):
            torch.cuda.synchronize()
            info = wave.spec_stats["info"][db.valid].double()
            r["k8_span_us"] = float(info[:, 1].max() - info[:, 0].min()) / 1e3
        r["copy"] = cs.time_ms(torch, lambda: gang.GangStatics(*(t.contiguous() for t in g0)), reps)
        r["k9"] = cs.time_ms(torch, lambda: wave.wave_admit(dc, db, g, hk, c0, *targs, **tkw), reps)
        if not wt["has_ports"]:
            r["k5"] = cs.time_ms(torch, lambda: gang.gang_schedule(dc, db, g, v_cap, d_cap=d_cap), reps)
            rows = cs.gang_rows(torch, dev, int(db.valid.sum().item()), db.valid.shape[0],
                                lambda i: 9 if i % 4 == 0 else 8)
            gk = [rows[k] for k in ("gang_id", "gang_first", "gang_last", "gang_need", "g_cap")]
            r["k11"] = cs.time_ms(torch, lambda: cos.workloads_admit(dc, db, g, hk, *targs, *gk, d_cap=d_cap,
                                                                     d2_cap=wt["d2_cap"]), reps)
        r.update(statics(torch, cs, gang, ops_fp, dc, db, hk, flags, reps))
        out[name] = r
    print(json.dumps(out), flush=True)
    return 0


def statics(torch, cs, gang, ops_fp, dc, db, hk, flags, reps):
    """K6's and K7's launches on one shape: their times (and spans where
    the checkout records them) and a digest of each launch's outputs."""
    st = ops_fp.static_eval_plain(dc, db, frozenset({"TaintToleration", "NodeAffinity"}), False)
    naff, taints = st["m_nodeaff"].contiguous(), st["m_taints"].contiguous()
    db0 = cs.without_own_terms(db)
    # (span kind, launch, the outputs it writes; None: all)
    launches = {"k7_ports_only": ("interpod", lambda: gang.interpod_statics(dc, db, do_interpod=False, do_ports=True),
                                  ("d_ports", "port_b"))}
    if flags["has_spread"]:
        launches["k6"] = ("spread", lambda: gang.spread_statics(dc, db, naff, taints, hk), None)
    if flags["has_interpod"]:
        launches["k7"] = ("interpod", lambda: gang.interpod_statics(dc, db, do_interpod=True, do_ports=True), None)
        launches["k7_ext_alone"] = ("interpod", lambda: gang.interpod_statics(dc, db0, do_interpod=True,
                                                                              do_ports=False),
                                    ("ip_viol_existing", "ip_sym"))
    r = {}
    for key, (which, fn, written) in launches.items():
        got = fn()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for k in sorted(written or got):
            h.update(k.encode())
            h.update(got[k].cpu().numpy().tobytes())
        r[key + "_sha256"] = h.hexdigest()[:16]
        r[key] = cs.time_ms(torch, fn, reps)
        if hasattr(gang, "statics_spans"):
            r[key + "_span_us"] = gang.statics_spans(which)
    return r


if __name__ == "__main__":
    sys.exit(main())
