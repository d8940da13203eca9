"""Sub-seeds of a run's ``--seed``: one stream per use, each a 32-bit
number (``numpy.random.SeedSequence``), so any whole number up to and
past 2**31 gives the same draws on every machine."""
from __future__ import annotations

import numpy as np

USES = ("volumes", "weights", "sampler", "augment", "requests", "sample",
        "program")


def sub_seeds(seed: int) -> dict:
    state = np.random.SeedSequence(int(seed)).generate_state(len(USES))
    return {use: int(s) for use, s in zip(USES, state)}
