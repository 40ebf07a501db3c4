"""Attention's least time over the traced requests' contexts (padding
included): the products at the float32 peak or q, k, v and the output
once over HBM, whichever is larger, over the device time of the attention
kernels (the configuration's ``attention_kernel``)."""

from benchmark import counts, harness


def read(run):
    t, cfg = run.trace, run.cell.config
    reqs = [r for r in run.counters.get("requests", ()) if r["traced"]]
    if t is None or not reqs:
        return None
    seconds, launches = t.kernels(cfg["attention_kernel"])
    if not launches:
        return None
    a = cfg["arch"]
    contexts = sum(r["contexts"] for r in reqs)
    flops = harness.load_flops(run.cell).attention_flops(cfg)
    nbytes = 4 * a["encoder_layers"] * 4 * a["max_source_positions"] \
        * a["d_model"]
    bound = contexts * counts.bound_s(nbytes, flops, run.card["name"])
    return 100.0 * bound / seconds
