"""The workloads tier's host half: PodGroups and the gang batch planner."""
