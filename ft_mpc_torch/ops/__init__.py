"""ft_mpc_torch.ops (PyTorch port of ft_mpc_tpu.ops)."""
