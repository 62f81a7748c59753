"""Times the workloads engine's kernels of one checkout on the card: K8
(wave_speculate) on the plain statics laid out two ways, and K5, K9 and K11
on the contiguous ones.

The four shapes are chip_smoke.py's wave rows: config4 and config3
(gang_shapes), ports and mixed (wave_shapes), each a batch of 512 pods.
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
    ap.add_argument("--shapes", default="config4,config3,ports,mixed", help="comma-separated shape names")
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
    from kubernetes_tpu_torch.ops import gang, wave

    _build.load()
    dev = torch.device("cuda")
    reps = args.reps
    out = dict(root=root, card=cs.card_line(), reps=reps)
    shapes = args.shapes.split(",")
    for name, nodes, placed, pending in cs.gang_shapes()[:2] + cs.wave_shapes():
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
        out[name] = r
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
