"""The step's share of the chip's peak: the model FLOPs of the window's
work (``portbench/flops.py``: top-k experts, causal and windowed pairs,
no recomputation) over the window's seconds and the card's bf16 peak,
in %."""

from portbench import flops


def read(record):
    peak = flops.peaks_for(record["device_name"])
    rate = record.get("model_flops_per_s")
    if peak is None or not rate:
        return None
    return 100.0 * rate / peak["flops"]
