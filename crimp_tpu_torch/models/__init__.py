"""models layer of the PyTorch port (mirrors crimp_tpu/models/)."""
