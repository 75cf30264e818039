"""The card's idle share of the traced window: 100 x (1 - the union of
its kernel, copy and fill intervals / the window)."""


def read(layer: dict):
    if not layer.get("window_s") or "busy_s" not in layer:
        return None
    return 100.0 * (1.0 - layer["busy_s"] / layer["window_s"])
