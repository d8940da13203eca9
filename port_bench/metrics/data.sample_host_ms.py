"""Host ms of one batch's sampling and augmentation: the mean of the
harness's span around each ``sample_batch`` and ``device_batch`` call in
the traced window."""


def read(record):
    spans = record.spans.get("sample") if record.kind == "train" else None
    return 1e3 * sum(spans) / len(spans) if spans else None
