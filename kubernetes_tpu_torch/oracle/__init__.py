"""Host scheduling semantics for one pod (the preemption dry run and the nominated-node path)."""
