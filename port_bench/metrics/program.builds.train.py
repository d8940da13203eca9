"""What the program built in the traced window of a train cell: the
number of its ``build.*`` spans (a kernel library built or loaded, a
CUDA graph captured, an eager warm-up step, a synthesis core made). The
set-up builds what the window runs, so anything above 0 is a build
inside the window."""
from port_bench.program_spans import builds


def read(record):
    return builds() if record.kind == "train" else None
