"""ft_mpc_torch.controllers (PyTorch port of ft_mpc_tpu.controllers)."""
