"""One-shot telemetry snapshot CLI (counterpart of
``paddle_tpu/observability/dump.py``, with its subcommands).

``python -m paddle_tpu_torch.observability.dump`` prints a JSON snapshot
of the in-process registry, the per-call-site collective log, and each
card's allocator statistics (``torch.cuda.memory_stats``) — the
no-debugger inspection path. For a
*running* server, ``--url http://host:port/metrics`` scrapes its
Prometheus endpoint instead (a separate process cannot see this
process's registry).

Options:
  --prometheus   emit Prometheus text format instead of JSON
  --no-device    skip device queries (safe on a wedged accelerator)
  --url URL      fetch a live endpoint and print it (point it at
                 /metrics for exposition text, or at /trace for a
                 server's Chrome trace JSON)
  --trace        emit the in-process lifecycle tracers as Chrome
                 trace-event JSON (load in Perfetto / chrome://tracing)
  --trace-jsonl  emit the raw tracer events as JSON-lines instead
  --fleet        fleet export: for every in-process EngineRouter, its
                 host-side fleet snapshot plus the MERGED router +
                 replica Chrome trace (failed-over rids joined by flow
                 events). For a *running* fleet server, point --url at
                 /trace?fleet=1 instead
  --timeline     every in-process TimeSeriesStore's retained windows
                 (PT_FLAGS_timeseries) as JSON. For a *running*
                 server, point --url at /timeline instead
"""

from __future__ import annotations

import argparse
import json
import sys


def _device_memory():
    import torch

    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i) or {}
        except Exception:
            stats = {}
        out.append({
            "device": f"cuda:{i}",
            "kind": torch.cuda.get_device_name(i),
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.dump",
        description="one-shot paddle_tpu_torch telemetry snapshot")
    ap.add_argument("--prometheus", action="store_true",
                    help="Prometheus text format instead of JSON")
    ap.add_argument("--no-device", action="store_true",
                    help="skip the card's allocator queries")
    ap.add_argument("--url", default=None,
                    help="scrape a live /metrics (or /trace) endpoint "
                         "instead")
    ap.add_argument("--trace", action="store_true",
                    help="Chrome trace-event JSON of the in-process "
                         "lifecycle tracers (Perfetto-loadable)")
    ap.add_argument("--trace-jsonl", action="store_true",
                    help="raw tracer events as JSON-lines")
    ap.add_argument("--fleet", action="store_true",
                    help="per-fleet snapshot + merged router+replica "
                         "Chrome trace (flow-correlated failovers)")
    ap.add_argument("--timeline", action="store_true",
                    help="every in-process time-series store's "
                         "retained windows (PT_FLAGS_timeseries) as "
                         "JSON — for a running server, point --url at "
                         "/timeline instead")
    args = ap.parse_args(argv)

    if args.url:
        from urllib.request import urlopen

        with urlopen(args.url, timeout=10) as resp:
            sys.stdout.write(resp.read().decode("utf-8", "replace"))
        return 0

    from . import comm, registry, timeseries, tracing

    if args.timeline:
        out = [s.snapshot() for s in timeseries.stores()]
        out.sort(key=lambda s: s["label"])
        json.dump(out, sys.stdout, default=str)
        sys.stdout.write("\n")
        if not out:
            print("dump --timeline: no in-process TimeSeriesStore "
                  "(PT_FLAGS_timeseries off, or no engine "
                  "constructed; use --url http://host:port/timeline "
                  "for a running server)", file=sys.stderr)
        return 0
    if args.fleet:
        out = []
        for fleet in tracing.fleets():
            out.append({
                # host counters — available with telemetry off
                "fleet_snapshot": fleet.fleet_snapshot(),
                "trace": tracing.fleet_chrome_trace(fleet),
            })
        json.dump(out, sys.stdout, default=str)
        sys.stdout.write("\n")
        if not out:
            print("dump --fleet: no in-process EngineRouter "
                  "registered (use --url http://host:port/trace?"
                  "fleet=1 for a running fleet server)",
                  file=sys.stderr)
        return 0
    if args.trace:
        json.dump(tracing.chrome_trace(), sys.stdout, default=str)
        sys.stdout.write("\n")
        return 0
    if args.trace_jsonl:
        out = tracing.jsonl()
        sys.stdout.write(out + ("\n" if out else ""))
        return 0

    if args.prometheus:
        sys.stdout.write(registry.global_registry().prometheus_text())
        return 0

    snap = {
        "telemetry_enabled": registry.enabled(),
        "metrics": registry.global_registry().snapshot(),
        "collectives": comm.comm_log(),
    }
    if not args.no_device:
        snap["device_memory"] = _device_memory()
    json.dump(snap, sys.stdout, indent=1, default=str)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
