"""utils layer of the PyTorch port (mirrors crimp_tpu/utils/)."""
