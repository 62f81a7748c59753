"""Times the preferred-affinity drain of one checkout on the card.

The drain is chip_smoke.py's "preferred" phase: 20,000 pods with one
preferred node-affinity term each on 10,000 tiered nodes, under the default
configuration, so that every batch takes the gang scan (K5).

    python3 preferred_drain_ab.py [ROOT] [--reps N]

ROOT (default: this script's directory) is the checkout whose port and
chip_smoke.py are imported.  To compare two commits on one machine, unpack
both and run this script once per checkout, in turns (A, B, B, A): each
process builds its checkout's kernels into that checkout.  Prints one JSON
line: the checkout, the card's name and power limit, each drain's seconds,
the K5 launches and the host seconds spent in K5's wrapper per drain, and
a digest of the placements (equal digests, equal placements).
"""

import argparse
import hashlib
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import gang

    _build.load()
    device = torch.device("cuda")
    inner = gang._gang_scan_cuda
    spent = [0.0]

    def timed(*a, **k):  # host seconds in K5's wrapper, its syncs included
        t0 = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            spent[0] += time.perf_counter() - t0

    gang._gang_scan_cuda = timed
    drains = []
    for _ in range(args.reps):
        _build.reset_launches()
        spent[0] = 0.0
        got, dt, _ = cs.drain(device, cs.tier_nodes(10000), cs.preferred_pods(20000))
        digest = hashlib.sha256(json.dumps(sorted(got.items())).encode()).hexdigest()[:16]
        drains.append(dict(drain_s=dt, gang_scan_launches=_build.launches["gang_scan"], k5_wrapper_s=spent[0],
                           placed=sum(v is not None for v in got.values()), placements_sha256=digest))
    print(json.dumps(dict(root=root, card=cs.card_line(), drains=drains)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
