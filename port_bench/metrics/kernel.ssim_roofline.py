"""The SSIM kernel's share of its roofline, in %: the least time of the
SSIM that the traced window's requests need (per request, every slice
that the function scores, at the larger of its bytes at 3.35 TB/s and its
operations at 67 TFLOP/s, from the volumes' shapes:
``counts.flops.ssim_counts``; slices that the program adds as padding
are not counted) over the device time of the kernels named
``ssim_band_kernel`` in the trace."""


def read(record):
    requests = record.counters.get("requests")
    if (record.kind != "score" or not requests
            or not record.counters.get("ssim_launches")):
        return None
    t = record.trace.device_time(lambda n: "ssim_band_kernel" in n)
    if t <= 0:
        return None
    return (100.0 * requests * record.counters["ssim_least_s_per_request"]
            / t)
