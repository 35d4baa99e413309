"""The MoE layer's share of its roofline: the summed least times of one
``MoeMLP`` forward at the cell's decode and prefill call shapes
(``flops.moe_call_work``: the k routed pairs, the weights of every expert
that receives a token) over their summed device times, in %."""

from portbench import flops


def read(record):
    calls = record.get("moe")
    peak = flops.peaks_for(record["device_name"])
    if not calls or peak is None:
        return None
    bound = sum(flops.roofline_seconds(c["flops"], c["bytes"], peak)
                for c in calls)
    return 100.0 * bound / sum(c["seconds"] for c in calls)
