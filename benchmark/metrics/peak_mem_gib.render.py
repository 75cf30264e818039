"""The most device memory the run's tensors held, in GiB
(``torch.cuda.max_memory_allocated`` after the window)."""


def read(layer: dict):
    peak = layer.get("peak_bytes")
    return peak / 2 ** 30 if peak else None
