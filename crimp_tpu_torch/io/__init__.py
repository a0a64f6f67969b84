"""io layer of the PyTorch port (mirrors crimp_tpu/io/)."""
