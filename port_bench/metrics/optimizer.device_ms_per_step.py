"""Device ms a step in the optimizer's ``_foreach`` kernels
(``multi_tensor_apply_kernel``, which only Adam launches in the training
step), from the trace."""


def read(record):
    if record.kind != "train" or not record.counters.get("steps"):
        return None
    t = record.trace.device_time(lambda n: "multi_tensor_apply_kernel" in n)
    return 1e3 * t / record.counters["steps"] if t > 0 else None
