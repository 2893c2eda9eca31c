"""Device ms a request of the kernels launched inside the Scorer's scorer.forward range."""

SPAN = "scorer.forward"


def read(run):
    if run.trace is None or run.mode != "serve":
        return None
    requests = sum(run.traced_buckets.values())
    spent = sum(op.device_s for op in run.trace.ops.get(SPAN, []))
    return 1e3 * spent / requests if spent > 0 and requests else None
