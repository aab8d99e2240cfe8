"""ft_mpc_torch.solvers (PyTorch port of ft_mpc_tpu.solvers)."""
