"""The scan's least time over the traced model calls (its operations at
the float32 peak or its bytes over HBM, whichever is larger, per chunk of a
slot and Mamba-2 layer), over the device time of the scan's kernels (the
configuration's ``scan_kernel``)."""

from benchmark import counts, harness


def read(run):
    t, cfg = run.trace, run.cell.config
    calls = [c for c in run.counters.get("calls", ()) if c["traced"]]
    if t is None or not calls:
        return None
    seconds, launches = t.kernels(cfg["scan_kernel"])
    if not launches:
        return None
    fl = harness.load_flops(run.cell)
    P = run.counters["positions"]
    chunks = sum(c["stream_chunks"] for c in calls)
    bound = chunks * cfg["layer_types"].count("mamba") * counts.bound_s(
        fl.scan_bytes(cfg, P), fl.scan_flops(cfg, P), run.card["name"])
    return 100.0 * bound / seconds
