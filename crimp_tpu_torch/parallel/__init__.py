"""Multi-process execution for the port (torch.distributed)."""
