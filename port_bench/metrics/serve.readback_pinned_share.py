"""Share, in %, of the served volumes read back into page-locked host
memory: the ``pinned`` counts of the program's ``serve.readback`` spans
over the ``volumes`` of its root ``serve.request`` spans. None where the
readback spans count no ``pinned``."""
from port_bench.program_spans import stored


def read(record):
    if record.kind != "serve":
        return None
    spans = stored()
    pinned = [s.counts["pinned"] for s in spans
              if s.name == "serve.readback" and "pinned" in s.counts]
    volumes = sum(s.counts.get("volumes", 0) for s in spans
                  if s.name == "serve.request" and s.parent is None)
    return 100.0 * sum(pinned) / volumes if pinned and volumes else None
