"""Device data-movement prices (scaling.py) and how the xfoot planner
uses them."""

import json

import numpy as np
import pytest

from sblas import scaling
from sblas.io.generate import webbase_like
from sblas.ops.route import routable_size
from sblas.parallel import xfoot_stats


@pytest.fixture(scope="module")
def web():
    return webbase_like(n=20_000, avg_deg=3.0, seed=3, local_scale=200.0,
                        dtype=np.float64)


def test_calibration_file_feeds_constants():
    """The committed record is the source of both prices, and the
    provenance names the device it was measured on."""
    calib = scaling._load_calib()
    assert calib is not None
    assert scaling.GATHER_NS == calib["gather_ns_median"] > 0
    assert scaling.ROUTE_NS == calib["route_ns_median"] > 0
    kind = calib["meta"]["device_kind"]
    assert kind in scaling.GATHER_NS_SRC and kind in scaling.ROUTE_NS_SRC


def test_env_overrides_calibration(monkeypatch):
    monkeypatch.setenv("SBLAS_GATHER_NS", "0.5")
    assert scaling._const("SBLAS_GATHER_NS", "gather_ns_median", 9.0) == (
        0.5, "env SBLAS_GATHER_NS")


def test_missing_calibration_falls_back_to_default(monkeypatch):
    monkeypatch.delenv("SBLAS_ROUTE_NS", raising=False)
    monkeypatch.setattr(scaling, "_CALIB", None)
    assert scaling._const("SBLAS_ROUTE_NS", "route_ns_median", 9.0) == (
        9.0, "default")


@pytest.mark.parametrize("content,ok", [
    ({"meta": {"device_kind": "X"}, "gather_ns_median": 1.5}, True),
    ("not json", False),
    (None, False),
])
def test_load_calib_reads_env_path(monkeypatch, tmp_path, content, ok):
    path = tmp_path / "calib.json"
    if content is not None:
        path.write_text(content if isinstance(content, str)
                        else json.dumps(content))
    monkeypatch.setenv("SBLAS_CALIB_FILE", str(path))
    got = scaling._load_calib()
    assert (got == content) if ok else got is None


def test_xfoot_mode_priced_from_stats(web):
    """The extraction time is the chosen engine's price times its
    element count, and the footprint exchange moves fewer bytes than
    mode 2's all-reduce of the whole result."""
    st = xfoot_stats(web, 8)
    slots = st.hot_own_max + st.n_shards * st.packet_pad
    r_x = ((web.shape[1] + 7) // 8 + 127) // 128 * 128
    flat = scaling.GATHER_NS * slots
    route = scaling.ROUTE_NS * routable_size(max(r_x, slots))
    assert st.extract_ns == pytest.approx(min(flat, route))
    assert st.extract_mode == ("flat" if flat <= route else "route")
    psum_bytes = 2.0 * web.shape[0] * 4 * 7 / 8
    assert 0 < st.comm_bytes(4) < psum_bytes


@pytest.mark.parametrize("cheap,mode", [("gather", "flat"),
                                        ("route", "route")])
def test_xfoot_engine_follows_prices(monkeypatch, web, cheap, mode):
    """Whichever engine is priced far cheaper is the one chosen."""
    monkeypatch.setattr(scaling, "GATHER_NS",
                        1e-6 if cheap == "gather" else 1e3)
    monkeypatch.setattr(scaling, "ROUTE_NS",
                        1e-6 if cheap == "route" else 1e3)
    assert xfoot_stats(web, 8).extract_mode == mode
