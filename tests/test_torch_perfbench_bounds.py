"""The benchmark's CPU comparisons of the program with its plain reference on
a configuration's bounds (`perfbench/tests/test_perfbench_bounds.py`: the
state box's and wrench rate's rows, the assembled QP and the line search,
a boxed tiny cell, a dropped bound, what is refused, the ADMM roofline's
work, the path without bounds, the near-orbit starts), collected here as
they stand, so that the tests under `tests/` hold the boxed deployment too.
The file stays the benchmark's; this module only loads it.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

_PATH = Path(__file__).resolve().parent.parent / "perfbench" / "tests" / "test_perfbench_bounds.py"
_spec = importlib.util.spec_from_file_location("perfbench_bounds_tests", _PATH)
_bounds = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_bounds)

globals().update({k: v for k, v in vars(_bounds).items() if k.startswith("test_")})
