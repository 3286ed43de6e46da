"""The device's idle share of the traced window, in %: 1 less the union of the
device's kernel, copy and set intervals over the window's length, both from the
``torch.profiler`` trace of the whole window (not of one proof)."""


def read(record: dict):
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
