"""Workload observability: the pod-level metric surface."""
