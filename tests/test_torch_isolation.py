"""ft_mpc_torch stands alone, and its committed bank snapshot is the bench bank.

1. A fresh interpreter imports every ft_mpc_torch module; neither `jax`
   nor any `ft_mpc_tpu` module may end up in sys.modules, nor matplotlib,
   which `viz/` imports only when a function runs.  A copy of the
   package builds its C++ hull engine into its own `build/` and builds a
   bank with it, without JAX, and leaves the JAX package's engine library
   (`ft_mpc_tpu/runtime/libftmpc_runtime.so`) as it found it.
2. `ft_mpc_torch/data/bench_bank32.npz` equals, leaf for leaf, a fresh
   build by the JAX package of the 32 patterns `bench.py:59-69` tiles
   (healthy, all 16 singles, the doubles (0, j) for j = 1..15), built
   with a scratch copy of the terminal cache so the repo's cache is never
   written.  `write_bench_bank` (also `python tests/test_torch_isolation.py`)
   regenerates the snapshot.
3. `ft_mpc_torch/data/demo_bank.npz` equals a fresh build of the demo's
   double fault (thrusters 10 and 11, `ft_mpc_tpu/config/reactive.yaml`)
   in terminal modes 'empc' and 'quadratic', with the tuning
   `examples/sim.py` builds it with; `write_demo_bank` regenerates it.
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
DEMO_SNAPSHOT = REPO / "ft_mpc_torch" / "data" / "demo_bank.npz"
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


def _build_flat(builds) -> dict[str, np.ndarray]:
    """Scenarios from the JAX package, stacked into a flat dict with float
    leaves float64: `builds(params)` returns the scenarios, each built with
    64-bit mode off (float32 plant, whose fingerprint keys the cached
    terminal ingredients), then widened to float64 without loss."""
    import jax

    from ft_mpc_torch.convert import flatten_namedtuple
    from ft_mpc_tpu.ops.dynamics import BodyParams

    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        flats = [flatten_namedtuple(sc) for sc in builds(BodyParams.default(0.1))]
    finally:
        jax.config.update("jax_enable_x64", x64)
    stacked = {k: np.stack([f[k] for f in flats]) for k in flats[0]}
    return {
        k: v.astype(np.float64) if v.dtype.kind == "f" else v
        for k, v in stacked.items()
    }


def build_bench_bank_flat(cache_dir) -> dict[str, np.ndarray]:
    """The bench bank from the JAX package, built exactly as bench.py builds it."""
    from ft_mpc_tpu.api import DEFAULT_TUNING, _build_scenario_with_terminal

    return _build_flat(lambda params: [
        _build_scenario_with_terminal(params, f, DEFAULT_TUNING, cache_dir=cache_dir)
        for f in bench_fault_patterns()
    ])


def demo_tuning() -> dict:
    """The tuning `examples/sim.py` builds its scenario with: DEFAULT_TUNING
    updated by the default run configuration (config/reactive.yaml)."""
    from ft_mpc_tpu.api import DEFAULT_TUNING
    from ft_mpc_tpu.utils.config import load_config

    return {**DEFAULT_TUNING, **load_config(None).tuning}


def build_demo_bank_flat(cache_dir) -> dict[str, np.ndarray]:
    """The demo's double fault (10, 11), one row per terminal mode of
    `ft_mpc_torch.geometry.scenario.DEMO_TERMINAL_MODES`."""
    from ft_mpc_torch.geometry.scenario import DEMO_TERMINAL_MODES
    from ft_mpc_tpu.api import _build_scenario_with_terminal
    from ft_mpc_tpu.utils.faults import BrokenThruster

    faults = [BrokenThruster(10, 1.0), BrokenThruster(11, 1.0)]
    return _build_flat(lambda params: [
        _build_scenario_with_terminal(params, faults, demo_tuning(), terminal_mode=mode,
                                      cache_dir=cache_dir)
        for mode in DEMO_TERMINAL_MODES
    ])


def _write(build, path) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        cache = Path(tmp) / "terminal_cache"
        shutil.copytree(TERMINAL_CACHE, cache)
        flat = build(str(cache))
    np.savez_compressed(path, **flat)


def write_bench_bank(path=SNAPSHOT) -> None:
    """Regenerate the committed snapshot (terminal cache used from a copy)."""
    _write(build_bench_bank_flat, path)


def write_demo_bank(path=DEMO_SNAPSHOT) -> None:
    """Regenerate the committed demo snapshot (terminal cache from a copy)."""
    _write(build_demo_bank_flat, path)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ft_mpc_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ft_mpc_torch.__path__, 'ft_mpc_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ft_mpc_tpu'))]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 73, names\n"
        "assert 'matplotlib' not in sys.modules  # viz/ imports it when a function runs\n"
        "for n in ('api', 'geometry.polytope', 'geometry.zonotope', 'geometry.invariant',\n"
        "          'geometry.scenario', 'runtime.native', 'terminal.quadratic',\n"
        "          'terminal.pipeline', 'terminal.reference_io', 'utils.faults',\n"
        "          'utils.config', 'controllers.spiral_params', 'controllers.orbit_search',\n"
        "          'controllers.certify', 'controllers.reference_solver',\n"
        "          'controllers.dummy', 'utils.logging', 'examples.sim', 'cli',\n"
        "          'benchmarks.accuracy', 'benchmarks.sanitizer',\n"
        "          'benchmarks.build_terminal_cache', 'benchmarks.scaling',\n"
        "          'benchmarks.pareto', 'benchmarks.diag_cleanup', 'benchmarks.diag_residual',\n"
        "          'benchmarks.diag_stub', 'benchmarks.ablate', 'parallel',\n"
        "          'parallel.mesh',\n"
        "          'parallel.distributed', 'parallel.launch', 'parallel.dryrun', 'models',\n"
        "          'models.planar', 'viz', 'viz.animate', 'viz.dashboards',\n"
        "          'viz.polytope_plot'):\n"
        "    assert 'ft_mpc_torch.' + n in names, n\n"
        "print(len(names))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_port_builds_its_own_hull_engine(tmp_path):
    """The port's engine builds into <checkout>/build/, never into or from
    the JAX package's tracked library; a copy of the checkout's two
    packages (the JAX one only for its data and engine files) keeps the
    JAX package's own tests, which may rebuild that library, out of the way."""
    shutil.copytree(REPO / "ft_mpc_torch", tmp_path / "ft_mpc_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    runtime = tmp_path / "ft_mpc_tpu" / "runtime"
    runtime.mkdir(parents=True)
    jax_lib = runtime / "libftmpc_runtime.so"
    shutil.copy2(REPO / "ft_mpc_tpu" / "runtime" / "libftmpc_runtime.so", jax_lib)
    shutil.copy2(REPO / "ft_mpc_tpu" / "runtime" / "zonotope_native.cpp", runtime)
    os.utime(jax_lib, ns=(1, 1))  # older than its source: the JAX package would rebuild
    before = jax_lib.read_bytes()
    code = (
        "import sys\n"
        "import torch\n"
        "from ft_mpc_torch.geometry.scenario import build_scenario_bank, default_fault_pool\n"
        "from ft_mpc_torch.ops.dynamics import BodyParams\n"
        "from ft_mpc_torch.runtime import native\n"
        "p = BodyParams.default(0.1, torch.float32, 'cpu')\n"
        "bank = build_scenario_bank(p, default_fault_pool()[:20], device='cpu')\n"
        "assert bank.scenarios.hull_mask.sum(dim=1).min() > 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ft_mpc_tpu'))]\n"
        "assert not bad, bad\n"
        "print(native.lib_path())\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lib = Path(out.stdout.strip().splitlines()[-1])
    assert lib.parent == tmp_path / "build" and lib.is_file()
    assert lib.name.startswith("zonotope_native-")
    assert jax_lib.read_bytes() == before and jax_lib.stat().st_mtime_ns == 1


def _check_fresh(build, path, tmp_path) -> dict[str, np.ndarray]:
    cache = tmp_path / "terminal_cache"
    shutil.copytree(TERMINAL_CACHE, cache)
    before = sorted(p.name for p in cache.iterdir())
    fresh = build(str(cache))
    # every pattern is already cached: the build adds no cache file
    assert sorted(p.name for p in cache.iterdir()) == before
    with np.load(path) as z:
        snap = {k: z[k] for k in z.files}
    assert sorted(snap) == sorted(fresh)
    for k in fresh:
        assert snap[k].dtype == fresh[k].dtype, k
        np.testing.assert_array_equal(snap[k], fresh[k], err_msg=k)
    return snap


def test_snapshot_matches_fresh_jax_build(tmp_path):
    snap = _check_fresh(build_bench_bank_flat, SNAPSHOT, tmp_path)
    assert snap["hull_A"].shape == (32, 32, 6)
    assert snap["term_A"].shape == (32, 64, 9)


def test_demo_snapshot_matches_fresh_jax_build(tmp_path):
    import torch

    from ft_mpc_torch.geometry.scenario import DEMO_TERMINAL_MODES, load_demo_scenario

    snap = _check_fresh(build_demo_bank_flat, DEMO_SNAPSHOT, tmp_path)
    assert snap["hull_A"].shape == (2, 32, 6)
    np.testing.assert_array_equal(snap["fault.broken"][:, 10:12], 1.0)
    assert snap["fault.broken"].sum() == 4
    for row, mode in enumerate(DEMO_TERMINAL_MODES):
        sc = load_demo_scenario(mode, device="cpu", dtype=torch.float64)
        assert sc.hull_A.shape == (32, 6)
        np.testing.assert_array_equal(sc.term.P.numpy(), snap["term.P"][row])
    # the two modes differ in their terminal ingredients only
    assert not np.array_equal(snap["term.P"][0], snap["term.P"][1])
    np.testing.assert_array_equal(snap["gen_G"][0], snap["gen_G"][1])


if __name__ == "__main__":
    write_bench_bank()
    write_demo_bank()
