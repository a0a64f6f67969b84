"""ops layer of the PyTorch port (mirrors crimp_tpu/ops/)."""
