"""Workload ops: core elementwise ops and the flash-attention kernels."""
