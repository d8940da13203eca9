"""The benchmark of the PyTorch/CUDA port (``superresolution_aniso_mri_tpu_torch``).

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with a CUDA card. Everything
is found by name from ``BENCHMARK.json``: a cell's configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<mix>.json`` (a
data file whose ``kind`` picks the driver ``drivers/<kind>.py``), the
limits of its correctness comparison in ``limits/<cell>.json``, and each
per-layer metric's reader in ``metrics/<metric>.py``. ``counts/`` holds
the frozen arithmetic (the H100's peaks, FLOPs and bytes from shapes) and
``reference/`` the plain float32 PyTorch reference that decides
``correct``; neither imports anything of the port.
"""
