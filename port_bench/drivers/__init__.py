"""One driver per kind of traffic (``train``, ``score``, ``serve``): a
``Job`` that sets a cell up from its seed, runs the window, and holds
what the window produced for the comparison with the reference.

``Job(cell, seed, device)`` builds and warms up; ``window(seconds)``
returns the window's counts; ``release()`` frees the program's state;
``program_outputs()`` and ``reference_outputs(mode, fault)`` give the two
sides that ``compare`` turns into the numbers held to the limits.
"""
