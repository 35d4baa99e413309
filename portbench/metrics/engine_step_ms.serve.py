"""The engine's batched step: the step ledger's total wall time over its
number of steps from the window's start to the last answer
(``models/requestlog.py``), in ms."""


def read(record):
    steps = record.get("recorder", {}).get("step_s")
    if not steps:
        return None
    return 1e3 * sum(steps) / len(steps)
