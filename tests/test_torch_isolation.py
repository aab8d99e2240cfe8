"""ft_mpc_torch stands alone, and its committed bank snapshot is the bench bank.

1. A fresh interpreter imports every ft_mpc_torch module; neither `jax`
   nor any `ft_mpc_tpu` module may end up in sys.modules.
2. `ft_mpc_torch/data/bench_bank32.npz` equals, leaf for leaf, a fresh
   build by the JAX package of the 32 patterns `bench.py:59-69` tiles
   (healthy, all 16 singles, the doubles (0, j) for j = 1..15), built
   with a scratch copy of the terminal cache so the repo's cache is never
   written.  `write_bench_bank` (also `python tests/test_torch_isolation.py`)
   regenerates the snapshot.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SNAPSHOT = REPO / "ft_mpc_torch" / "data" / "bench_bank32.npz"
TERMINAL_CACHE = REPO / "ft_mpc_tpu" / "config" / "terminal_cache"


def bench_fault_patterns():
    """The first 32 patterns of bench.py's census, as (index, intensity) lists."""
    from ft_mpc_tpu.utils.faults import BrokenThruster

    pats = [[]]
    pats += [[BrokenThruster(i, 1.0)] for i in range(16)]
    pats += [
        [BrokenThruster(i, 1.0), BrokenThruster(j, 1.0)]
        for i in range(16)
        for j in range(i + 1, 16)
    ]
    return pats[:32]


def build_bench_bank_flat(cache_dir) -> dict[str, np.ndarray]:
    """The bench bank from the JAX package as a flat dict, float leaves float64.

    Built exactly as bench.py builds it, with 64-bit mode off (float32
    plant, whose fingerprint keys the cached terminal ingredients), then
    widened to float64 without loss.
    """
    import jax

    from ft_mpc_torch.convert import flatten_namedtuple
    from ft_mpc_tpu.api import DEFAULT_TUNING, _build_scenario_with_terminal
    from ft_mpc_tpu.ops.dynamics import BodyParams

    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        params = BodyParams.default(0.1)
        flats = [
            flatten_namedtuple(
                _build_scenario_with_terminal(
                    params, f, DEFAULT_TUNING, cache_dir=cache_dir
                )
            )
            for f in bench_fault_patterns()
        ]
    finally:
        jax.config.update("jax_enable_x64", x64)
    stacked = {k: np.stack([f[k] for f in flats]) for k in flats[0]}
    return {
        k: v.astype(np.float64) if v.dtype.kind == "f" else v
        for k, v in stacked.items()
    }


def write_bench_bank(path=SNAPSHOT) -> None:
    """Regenerate the committed snapshot (terminal cache used from a copy)."""
    with tempfile.TemporaryDirectory() as tmp:
        cache = Path(tmp) / "terminal_cache"
        shutil.copytree(TERMINAL_CACHE, cache)
        flat = build_bench_bank_flat(str(cache))
    np.savez_compressed(path, **flat)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ft_mpc_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ft_mpc_torch.__path__, 'ft_mpc_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ft_mpc_tpu'))]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 22, names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_snapshot_matches_fresh_jax_build(tmp_path):
    cache = tmp_path / "terminal_cache"
    shutil.copytree(TERMINAL_CACHE, cache)
    before = sorted(p.name for p in cache.iterdir())
    fresh = build_bench_bank_flat(str(cache))
    # every pattern is already cached: the build adds no cache file
    assert sorted(p.name for p in cache.iterdir()) == before
    with np.load(SNAPSHOT) as z:
        snap = {k: z[k] for k in z.files}
    assert sorted(snap) == sorted(fresh)
    for k in fresh:
        assert snap[k].dtype == fresh[k].dtype, k
        np.testing.assert_array_equal(snap[k], fresh[k], err_msg=k)
    assert snap["hull_A"].shape == (32, 32, 6)
    assert snap["term_A"].shape == (32, 64, 9)


if __name__ == "__main__":
    write_bench_bank()
