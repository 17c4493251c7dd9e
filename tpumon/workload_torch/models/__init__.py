"""Workload models (dense Llama-style decoder)."""
