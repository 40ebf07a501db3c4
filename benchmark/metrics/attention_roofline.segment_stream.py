"""Attention's least time over the traced model calls, over the keys and
values each chunk's queries attended (carried and the chunk's: the
program's counter segment.kv_positions): the products at the float32 peak
or the queries, outputs, keys and values once over HBM, whichever is
larger, over the device time of the attention kernels (the configuration's
``attention_kernel``)."""

from benchmark import counts, harness


def read(run):
    t, cfg = run.trace, run.cell.config
    calls = [c for c in run.counters.get("calls", ()) if c["traced"]]
    if t is None or not calls:
        return None
    seconds, launches = t.kernels(cfg["attention_kernel"])
    if not launches:
        return None
    fl = harness.load_flops(run.cell)
    P = run.counters["positions"]
    chunks = sum(c["stream_chunks"] for c in calls)
    kv = sum(c["kv_positions"] for c in calls)
    bound = counts.bound_s(fl.attention_bytes(cfg, chunks, kv, P),
                           fl.attention_flops(cfg, chunks, kv, P),
                           run.card["name"])
    return 100.0 * bound / seconds
