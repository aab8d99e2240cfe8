"""ft_mpc_torch.terminal (PyTorch port of ft_mpc_tpu.terminal)."""
