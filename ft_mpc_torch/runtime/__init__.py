"""ft_mpc_torch.runtime (PyTorch port of ft_mpc_tpu.runtime): the native
host engine for batched wrench hulls."""
