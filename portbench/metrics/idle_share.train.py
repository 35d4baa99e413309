"""The device's idle share over the traced slice of the window: the share
of wall time in which no operation ran on the card (``torch.profiler``'s
device activity, merged), in %."""


def read(record):
    tr = record.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
