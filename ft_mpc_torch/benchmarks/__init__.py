"""ft_mpc_torch.benchmarks (PyTorch port of benchmarks/)."""
