"""Multi-process parallelism of the port (torch.distributed process groups)."""
