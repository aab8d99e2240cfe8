"""ft_mpc_torch.geometry (PyTorch port of ft_mpc_tpu.geometry)."""
