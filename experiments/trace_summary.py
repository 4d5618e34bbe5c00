#!/usr/bin/env python3
"""Summarize jax.profiler traces from profiling.py.

The reference's observability story is `nsys profile` with UM page-fault
counters (profiling.sh:3-21); ours is jax.profiler.  This tool turns the
captured Chrome-trace JSON (`*.trace.json.gz` under each trace dir) into
the numbers a reader actually wants:

* wall time of the traced scope (the named TraceAnnotation);
* device busy time (sum of `XLA Ops` events on the device pid) and its
  fraction of wall — the compute/transfer overlap figure;
* host->device transfer dispatch time (device_put / BatchedCopyToDevice
  host events) — the page-migration analog;
* top device ops by total duration.

Pure stdlib; runs offline on trace dirs.

    python experiments/trace_summary.py traces/*
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys

_XFER_HOST = ("BatchedCopyToDeviceWithSharding",
              "batched_copy_array_to_devices_with_shard", "device_put")


def load_trace(trace_dir: str) -> list:
    paths = glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace.json.gz under {trace_dir}")
    with gzip.open(sorted(paths)[-1]) as fh:
        return json.load(fh)["traceEvents"]


def summarize(trace_dir: str) -> dict:
    ev = load_trace(trace_dir)
    pids, tids = {}, {}
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pids[e["pid"]] = e["args"]["name"]
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tids[(e["pid"], e["tid"])] = e["args"]["name"]
    dev_pids = {p for p, n in pids.items() if "/device:" in n}
    # device op events: the "XLA Ops" line where the backend has one,
    # else the GPU's per-stream lines ("Stream #N(...)")
    dev_tids = {k for k, n in tids.items()
                if k[0] in dev_pids and n == "XLA Ops"}
    if not dev_tids:
        dev_tids = {k for k, n in tids.items()
                    if k[0] in dev_pids and n.startswith("Stream")}
    name = os.path.basename(trace_dir.rstrip("/"))
    xs = [e for e in ev if e.get("ph") == "X"]
    # wall = full event span: the named scope's own duration can end
    # before async device work drains (observed on the 4-band spmm trace:
    # scope 2.9 ms vs 58 ms of device busy behind it)
    scope = next((e for e in xs if e["name"] == name), None)
    # timestamps are NOT comparable across pids (device events run on a
    # different clock base) — span per pid, take the max
    # profiler bookkeeping events carry garbage durations in some captures
    # (a stop_trace with dur=422,000 s observed) — exclude them
    bogus = ("$profiler", "$contextlib", "$<unknown")
    span_us = 0.0
    for pid in pids:
        pe = [e for e in xs if e.get("pid") == pid
              and not e["name"].startswith(bogus)]
        if pe:
            span_us = max(span_us,
                          max(e["ts"] + e.get("dur", 0) for e in pe)
                          - min(e["ts"] for e in pe))
    wall_us = max(scope["dur"] if scope else 0, span_us)

    dev_ops = [e for e in xs if (e.get("pid"), e.get("tid")) in dev_tids]
    # overlap-aware busy time: merge [ts, ts+dur) intervals
    ivs = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in dev_ops)
    busy = 0.0
    cur_s = cur_e = None
    for s, t in ivs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s

    xfer_us = sum(e.get("dur", 0) for e in xs
                  if e.get("pid") not in dev_pids
                  and any(e["name"].startswith(p) for p in _XFER_HOST))
    top = collections.Counter()
    for e in dev_ops:
        top[e["name"]] += e.get("dur", 0)
    return {
        "trace": name,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_busy_frac": busy / wall_us if wall_us else 0.0,
        "host_transfer_dispatch_ms": xfer_us / 1e3,
        "n_device_ops": len(dev_ops),
        "top_device_ops": [(n, round(d / 1e3, 4))
                           for n, d in top.most_common(8)],
        "device_threads": sorted(tids[k] for k in dev_tids),
    }


def main(argv) -> int:
    dirs = argv or sorted(glob.glob("traces/*"))
    for d in dirs:
        if not os.path.isdir(d):
            continue
        s = summarize(d)
        print(f"{s['trace']}: wall {s['wall_ms']:.1f} ms, device busy "
              f"{s['device_busy_ms']:.1f} ms ({s['device_busy_frac']*100:.0f}"
              f"% of wall), host transfer dispatch "
              f"{s['host_transfer_dispatch_ms']:.1f} ms, "
              f"{s['n_device_ops']} device ops")
        for n, ms in s["top_device_ops"]:
            print(f"    {ms:9.3f} ms  {n}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
