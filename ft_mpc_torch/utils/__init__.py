"""ft_mpc_torch.utils (PyTorch port of ft_mpc_tpu.utils)."""
