"""ft_mpc_torch.sim (PyTorch port of ft_mpc_tpu.sim): closed-loop rollouts."""
