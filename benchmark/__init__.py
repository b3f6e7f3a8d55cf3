"""The benchmark of the PyTorch and CUDA port (`wacv23_tsnet_tpu_torch`)."""
