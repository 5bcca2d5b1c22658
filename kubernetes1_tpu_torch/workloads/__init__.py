"""The workloads the orchestrator schedules, in PyTorch (Llama serving first)."""
