"""Attention's share of its roofline at the training cell's shape: the
least time the forward and backward work could take on the card
(``flops.attention_train_work``) over the device time of the port's
public attention entry, forward and backward, timed with CUDA events
after the window, in %."""

from portbench import flops


def read(record):
    a = record.get("attention")
    peak = flops.peaks_for(record["device_name"])
    if not a or peak is None:
        return None
    return 100.0 * flops.roofline_seconds(a["flops"], a["bytes"], peak) \
        / a["seconds"]
