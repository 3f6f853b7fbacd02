"""The 95th percentile of the window's request latencies (ms): each request
from its call's enqueue to the host seeing its completion event."""


def read(run, cell):
    return (run.get("e2e") or {}).get("serve_p95_ms")
