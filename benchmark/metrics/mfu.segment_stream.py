"""Forward FLOPs of the real positions the window's model calls served
(the program's counter segment.stream_positions: the stem, every layer's
products and the heads), with each slot's chunk's scan over its real
positions and attention of its real queries over the keys they attend
(carried and the chunk's), and the front end's operations over every
broadcast featurized in the window, over the window's wall time at the
float32 peak.  A chunk's padding counts as no work."""

from benchmark import counts, harness, readers


def read(run):
    c, cfg = run.counters, run.cell.config
    calls = c.get("calls")
    if not calls or not c.get("stream_positions") or run.window_s <= 0:
        return None
    fl = harness.load_flops(run.cell)
    mamba = cfg["layer_types"].count("mamba")
    work = c["stream_positions"] * fl.forward_flops(cfg)
    for call in calls:
        for carried, n in call["fed"]:
            work += (mamba * fl.scan_flops(cfg, n)
                     + fl.attention_flops_fed(cfg, carried, n))
    work += sum(readers.frontend_flops(cfg, r["frames"])
                for r in c.get("requests", ()))
    return 100.0 * work / (run.window_s * counts.f32_peak(run.card["name"]))
