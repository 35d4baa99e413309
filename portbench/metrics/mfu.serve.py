"""The step's share of the chip's peak: the model FLOPs of the window's
work (``portbench/flops.py``: top-k experts, causal and windowed pairs,
no recomputation) over its seconds (for serving, from the window's start
to the last answer) and the card's bf16 peak, in %."""

from portbench import flops


def read(record):
    peak = flops.peaks_for(record["device_name"])
    rate = record.get("model_flops_per_s")
    if peak is None or not rate:
        return None
    return 100.0 * rate / peak["flops"]
