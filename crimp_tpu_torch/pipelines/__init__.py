"""pipelines layer of the PyTorch port (mirrors crimp_tpu/pipelines/)."""
