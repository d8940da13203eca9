"""Host ms a step of drawing the step's noise (``Trainer.draw_noise``):
the program's ``train.noise`` spans over the ``steps`` of the root
``train.dispatch`` spans. Only the families that draw noise (the VAE's
reparametrisation, ACAI's critic alphas) open the span."""
from port_bench.program_spans import ms_per


def read(record):
    if record.kind != "train":
        return None
    return ms_per(("train.noise",), "train.dispatch", "steps")
