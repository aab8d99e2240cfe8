"""Multi-device scaling: scenario-axis sharding over a list of devices."""

from ft_mpc_torch.parallel.mesh import (  # noqa: F401
    make_scenario_mesh,
    shard_scenario_batch,
    sharded_rollout,
    sharded_control_step,
)
