"""ft_mpc_torch.examples (PyTorch port of examples/)."""
