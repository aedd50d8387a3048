"""The window's peak of allocated device memory
(``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start), in GiB."""


def read(record):
    if not record["peak_bytes"]:
        return None
    return record["peak_bytes"] / 2**30
