"""95th percentile, in ms, of the served requests' latency in the traced
window (the call until the result is in host memory): the harness's span
around each request. The tail of a single client's requests swings with
the host's stalls from run to run, so it is read here, beside the
throughput it should move, and not held to a bound."""
import numpy as np


def read(record):
    spans = record.spans.get("request") if record.kind == "serve" else None
    return 1e3 * float(np.percentile(spans, 95)) if spans else None
