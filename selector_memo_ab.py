"""The preemption parity phase of chip_smoke.py under two memos of the port
oracle's compiled label selectors, taken in turns (object, content,
content, object) in one process: the memo on the selector object
(kubernetes_tpu_torch/oracle/filters.py compiled_selector) and a memo on
the selector's content (an lru_cache keyed on the sorted match_labels and
the expression tuples).  The phase itself holds the decisions equal (the
drain on cuda against the drain on the CPU).  Prints the card's name and
power limit, then one JSON line per run: the memo, the phase's wall
seconds and its two drains' seconds.

    python3 selector_memo_ab.py        # on a machine with a CUDA card
"""

from __future__ import annotations

import functools
import json
import sys
import time

import chip_smoke


def content_memo():
    from kubernetes_tpu_torch.api import labels as k8slabels

    @functools.lru_cache(maxsize=4096)
    def compiled(labels, exprs):
        return k8slabels.Selector(tuple(k8slabels.Requirement(k, k8slabels.IN, (v,)) for k, v in labels)
                                  + tuple(k8slabels.Requirement(k, op, vals) for k, op, vals in exprs))

    def compiled_selector(ls):
        if ls is None:
            return k8slabels.NOTHING
        return compiled(tuple(sorted((ls.match_labels or {}).items())),
                        tuple((e.key, e.operator, tuple(e.values or ())) for e in ls.match_expressions or ()))

    return compiled_selector


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("selector_memo_ab: CUDA is not available", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.oracle import filters

    print(chip_smoke.card_line(), flush=True)
    _build.load()
    device = torch.device("cuda", 0)
    by_object = filters.compiled_selector
    for name in ("object", "content", "content", "object"):
        filters._COMPILED.clear()  # each run starts with an empty memo
        filters.compiled_selector = by_object if name == "object" else content_memo()
        t0 = time.perf_counter()
        chip_smoke.phase_preempt_parity(torch, device)
        print(json.dumps({"memo": name, "phase_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
