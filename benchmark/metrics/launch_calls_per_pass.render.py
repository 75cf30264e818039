"""Host calls that put work on the card (kernel launches, copies, fills,
graph launches; the profiler's runtime and driver events) per traced
pass.  A segment replayed as a CUDA graph counts one call, not its
kernels."""


def read(layer: dict):
    if not layer.get("passes") or "runtime_calls" not in layer:
        return None
    return layer["runtime_calls"] / layer["passes"]
