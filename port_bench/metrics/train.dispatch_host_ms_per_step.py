"""Host ms a step of the dispatch (``Trainer.train_many``): the
program's ``train.dispatch`` spans over their ``steps``: the host
launches the noise, the scalars, the copies and the graph replays, which
run on the card asynchronously, and waits where the launch queue is
full."""
from port_bench.program_spans import ms_per


def read(record):
    if record.kind != "train":
        return None
    return ms_per(("train.dispatch",), "train.dispatch", "steps")
