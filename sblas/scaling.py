"""Device data-movement prices for the xfoot planner (parallel/xfoot.py).

`GATHER_NS` is XLA's elementwise gather cost and `ROUTE_NS` the routed
permutation's (ops/route.py) cost, both in ns per element; the planner
prices its two extraction engines with them.  They come from
`scaling_calib.json` at the repo root, written by
experiments/calibrate_scaling.py with the device kind it ran on; an
SBLAS_GATHER_NS / SBLAS_ROUTE_NS environment variable overrides the
file, and the built-in defaults are that file's values.  Multi-device
times are measured, not modelled (chip_smoke.py --devices 4).
"""

from __future__ import annotations

import json
import os


def _load_calib():
    """Device calibration record written by
    experiments/calibrate_scaling.py — per-size measurements plus the
    median the planner consumes, with the device kind they came from."""
    path = os.environ.get(
        "SBLAS_CALIB_FILE",
        os.path.join(os.path.dirname(__file__), "..", "scaling_calib.json"))
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


_CALIB = _load_calib()


def _const(env: str, calib_key: str, default: float):
    """(value, provenance) with env > calibration file > default."""
    if env in os.environ:
        return float(os.environ[env]), f"env {env}"
    if _CALIB and calib_key in _CALIB:
        meta = _CALIB.get("meta", {})
        return float(_CALIB[calib_key]), (
            f"measured {meta.get('date', '?')} on "
            f"{meta.get('device_kind', meta.get('platform', '?'))}")
    return default, "default"


GATHER_NS, GATHER_NS_SRC = _const("SBLAS_GATHER_NS", "gather_ns_median",
                                  0.0134)
ROUTE_NS, ROUTE_NS_SRC = _const("SBLAS_ROUTE_NS", "route_ns_median",
                                0.0523)
