"""The 90th percentile, over every period of the untraced window, of one
period's latency: from the states handed to `get_control_batch` to the
thruster commands on the host.  The tail a flight computer meets; host
stalls of a shared machine swing it run to run (IQR 13-24% of the median
over six runs, NVIDIA H100 80GB HBM3 at 700 W), so it stands beside
`step_ms` and is not held to a bound."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(1e3 * np.asarray(run.latencies_s), 90))
