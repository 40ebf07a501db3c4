"""Several live channels labelled by a causal stream model
(Granite-Hybrid-MTL), as ``cli/segment.py`` serves one file but with
``streams`` slots side by side: a broadcast given a slot is read
(``read_audio``) and featurized (``_featurize_broadcast``, K1 at 128 bands,
slabbed past 16384 frames), then each model call of the segmenter's
'stream' mode (``StreamSlots.step``) advances every slot by one 30-s chunk,
its state carried from the slot's last chunk; the tracks go to the host
after every call, and a finished broadcast's S track is median-smoothed.
The model is built and given its weights once in set-up: the values of
``harness.seeded_weights``, drawn on the card and written into the model's
own tensors (3 B of them: no host copy, and the reference reads the same
tensors).

Closed loop: the slots take the pool's broadcasts in a seeded permutation;
a slot whose broadcast ends is reset and takes the next.  The window's
audio is that of the chunks whose tracks reached the host in it (the call
in progress at the deadline completes and counts).  Set-up runs the
shortest broadcast in three slots and the first two chunks of the longest
in the fourth (every shape of a call, the finishing and the smoothing,
keys and values carried), then resets every slot.  A traced run profiles
the calls that start in the window's last ``trace_seconds``: the mix's 30
trace the whole window, since a broadcast is read and featurized only when
a slot takes it (the first four at the window's start), and the program
records its spans only while the profiler runs.  The peak
memory is the window's (the set-up's uniform draws for the weights, on the
card beside the model's, are left out; standard error gives both).

The check: up to ``check_requests`` broadcasts, first the one whose slot
had carried the most positions at the deadline, whether it ended or not,
then the shortest that ended, then others the window served drawn from the
seed.  For each, the reference (``reference/segment_stream.py``) reads the
same wav and makes one causal pass over the chunks the program fed; every
track of every chunk is compared, and where the broadcast ended, the
smoothed S track and the labels too (as ``segment.py``'s readings).
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .. import harness
from ..reference import segment_stream as ref_stream
from ..trace import Profiler
from ..traffic import generate
from .segment import _TimedSmoothing

COUNTERS = ("segment.stream_chunks", "segment.stream_positions",
            "segment.padded_frames", "segment.kv_positions",
            "segment.state_resets", "ssd_scan.launches")


def serve_settings(cell: harness.Cell) -> dict:
    mix = cell.mix
    return {"context_frames": mix["context_frames"],
            "smooth_win": mix["smooth_win"],
            "slab_threshold": mix["slab_threshold"]}


def seeded_on_card(net, seed: int, device, cfg: dict) -> dict:
    """``harness.seeded_weights(net, seed, device, cfg)``'s values written
    into ``net``'s own tensors on ``device``, in place of a host copy;
    returns ``net``'s floating-point state by name (the same tensors)."""
    from ..reference import models
    own = getattr(models.family(cfg), "init_leaf", None)
    state = net.state_dict()
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(t.numel() for t in state.values()), generator=gen,
                   device=device)
    pos = 0
    with torch.no_grad():
        for name, t in state.items():
            v = u[pos:pos + t.numel()].view(t.shape)
            pos += t.numel()
            if name.endswith("num_batches_tracked"):
                t.zero_()
                continue
            w = own(name, v, cfg) if own is not None else None
            t.copy_(w if w is not None else harness._default_leaf(name, v))
    return {k: t for k, t in state.items() if t.is_floating_point()}


def _counters() -> dict:
    from sm_hpss_mtl_tpu_torch.utils import profiling
    read = getattr(profiling, "counters", None)
    c = read() if read is not None else {}
    return {k: c.get(k, 0) for k in COUNTERS}


class StreamCell:
    """The program's stream segmenter for one cell: its model with the
    seeded weights and ``streams`` slots."""

    def __init__(self, cell: harness.Cell, seed: int, device, spans):
        from sm_hpss_mtl_tpu_torch.cli.segment import segmenter
        from sm_hpss_mtl_tpu_torch.models.zoo import get_model
        from sm_hpss_mtl_tpu_torch.train.config import MODEL_PRESETS
        cfg, mix = cell.config, cell.mix
        self.device, self.mix, self.spans = device, mix, spans
        with torch.device(device):
            net = get_model(cfg["model"], n_mels=cfg["features"]["n_mels"],
                            **cfg["program"]["arch_kwargs"])
        self.weights = seeded_on_card(net, seed, device, cfg)
        self.net = net.eval()
        self.preset = MODEL_PRESETS[cfg["model"]]
        self.seg = segmenter(cfg["model"], self.net)
        if self.seg.context_frames != mix["context_frames"]:
            raise ValueError(f"the model takes {self.seg.context_frames}-"
                             f"frame chunks, the mix {mix['context_frames']}")
        self.stream = self.seg.slots(mix["streams"], device)
        self.requests: list[dict] = []

    def assign(self, slot: int, key, path: str, traced: bool = False) -> None:
        """Read and featurize ``path``, and give it ``slot``; one
        ``requests`` entry (frames, samples, whether the profiler ran) per
        broadcast featurized."""
        from sm_hpss_mtl_tpu_torch.cli.segment import _featurize_broadcast
        from sm_hpss_mtl_tpu_torch.data.audio import read_audio
        with self.spans("read_audio"):
            x, _ = read_audio(path)
        with self.spans("featurize", sync=True):
            fv = _featurize_broadcast(x, self.preset, self.device)
        self.requests.append({"frames": fv.shape[1], "n_samples": len(x),
                              "traced": traced})
        self.stream.assign(slot, key, fv)

    def step(self) -> dict:
        with self.spans("call"):
            return self.stream.step(self.mix["head"], self.mix["smooth_win"])

    def close(self) -> None:
        self.net = self.seg = self.stream = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def check_sample(seed: int, served: dict, deadline_key, k: int) -> list:
    """Served broadcasts to check: the one whose slot carried the most
    positions at the deadline, the shortest that ended, then others drawn
    from the seed, ``k`` in all."""
    ended = sorted((key for key, s in served.items() if s["ended"]),
                   key=lambda key: served[key]["seconds"])
    first = [deadline_key] + [key for key in ended[:1]
                              if key != deadline_key]
    rest = [key for key in served if key not in first]
    rng = np.random.default_rng([seed, 2])
    rng.shuffle(rest)
    return (first + rest)[:k]


def readings(prog: list, ref: list, smooth_limit: float) -> tuple[dict, list]:
    """The compared numbers over the checked broadcasts, and faults: every
    track's gap over the chunks fed; for the ended ones the smoothed
    track's gap and the label flips."""
    track = smooth = 0.0
    flips = 0
    faults = []
    for p, r in zip(prog, ref):
        for head, want in r["tracks"].items():
            got = p["tracks"].get(head)
            if got is None or got.shape != want.shape:
                faults.append(f"track {head}: shape "
                              f"{None if got is None else got.shape} "
                              f"against {want.shape}")
                continue
            track = max(track, float(np.abs(got - want).max()))
        if not p["ended"]:
            continue
        if "smoothed" not in r or p["smoothed"].shape != r["smoothed"].shape:
            faults.append("smoothed track: wrong length")
            continue
        smooth = max(smooth, float(np.abs(p["smoothed"]
                                          - r["smoothed"]).max()))
        clear = np.abs(r["smoothed"] - 0.5) > smooth_limit
        flips += int(((p["labels"] != r["labels"]) & clear).sum())
    return ({"track_gap": track, "smooth_gap": smooth, "label_flips": flips},
            faults)


def _reference(checked: list, served: dict, pool: list, weights: dict,
               cell: harness.Cell, device, **kw) -> list:
    settings = serve_settings(cell)
    return [ref_stream.segment(pool[served[key]["pool"]]["path"], weights,
                               cell.config, settings, device,
                               chunks=served[key]["chunks"], **kw)
            for key in checked]


def _warm(prog: StreamCell, pool: list) -> None:
    """The longest broadcast's first two chunks in slot 0 beside the
    shortest in the others, then every slot reset."""
    stream = prog.stream
    prog.assign(0, "warm-long", pool[-1]["path"])
    for slot in range(1, stream.state.slots):
        prog.assign(slot, f"warm-{slot}", pool[0]["path"])
    for _ in range(2):
        prog.step()
    for slot in range(stream.state.slots):
        stream.state.reset(slot)
        stream.slots[slot] = None
    prog.requests.clear()


def _slots_fed(stream, L: int) -> list:
    """For each busy slot of ``stream``, ``[carried positions, real
    positions of its next chunk]``."""
    out = []
    for slot, s in enumerate(stream.slots):
        if s is not None:
            frames = min(L, s.fv.shape[1] - s.fed)
            out.append([stream.state.lengths[slot], -(-frames // 2)])
    return out


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, card: dict,
        with_controls: bool = False) -> harness.Run:
    mix, feat = cell.mix, cell.config["features"]
    hop = feat["hop_length"] / feat["sr"]
    run = harness.Run(cell=cell, card=card, spans=harness.Spans(traced))
    with tempfile.TemporaryDirectory(prefix="bench-segment-stream-") as root:
        pool = generate.make_pool(os.path.join(root, "pool"), seed,
                                  mix["pool"])
        run.setup.mark("pool")
        prog = StreamCell(cell, seed, device, run.spans)
        run.setup.mark("model")
        _warm(prog, pool)
        run.spans.records.clear()
        order = generate.request_order(seed, len(pool))
        profiler = Profiler() if traced else None
        if profiler is not None:
            profiler.prime()
        run.setup.mark("warmup")
        trace_from = max(0.0, seconds - mix["trace_seconds"])
        stream = prog.stream
        served: dict[int, dict] = {}
        holder = [None] * stream.state.slots
        calls = []
        smoothing = (_TimedSmoothing(run.spans) if traced
                     else contextlib.nullcontext())
        with smoothing:
            harness.sync(device)
            setup_peak = harness.memory_peak(device)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            before = _counters()
            run.window_start = time.time()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                if profiler is not None and not profiler.active \
                        and time.perf_counter() - t0 >= trace_from:
                    profiler.start()
                tracing = profiler is not None and profiler.active
                for slot in stream.free():
                    i = next(order)
                    key = len(served)
                    served[key] = {"pool": i, "seconds": pool[i]["seconds"],
                                   "chunks": 0, "ended": False}
                    holder[slot] = key
                    prog.assign(slot, key, pool[i]["path"], tracing)
                busy = [holder[s] for s in range(len(holder))
                        if stream.slots[s] is not None]
                fed = _slots_fed(stream, mix["context_frames"])
                c0 = _counters()
                run.attempted += 1
                try:
                    out = prog.step()
                except Exception as e:  # a call that never answers
                    run.failed += 1
                    run.faults.append(f"call {run.attempted}: "
                                      f"{type(e).__name__}: {e}")
                    break
                c1 = _counters()
                for key in busy:
                    served[key]["chunks"] += 1
                for done in out["finished"]:
                    served[done["key"]].update(ended=True, out=done)
                calls.append({
                    "frames": out["frames"], "traced": tracing, "fed": fed,
                    **{k.split(".")[1]: c1[k] - c0[k] for k in COUNTERS}})
            harness.sync(device)
            run.window_s = time.perf_counter() - t0
            after = _counters()
        if profiler is not None and profiler.active:
            profiler.stop()
            run.trace = profiler.summary
        run.memory_peak_bytes = harness.memory_peak(device)
        print(f"memory: window peak {run.memory_peak_bytes / 1e9:.2f} GB, "
              f"set-up peak {setup_peak / 1e9:.2f} GB", file=sys.stderr)
        # The broadcast whose slot carried the most positions, and what the
        # slots still held at the deadline.
        lengths = stream.state.lengths
        deadline_key = holder[int(np.argmax(lengths))]
        for slot, key in enumerate(holder):
            if key is not None and stream.slots[slot] is not None \
                    and stream.slots[slot].key == key:
                served[key]["out"] = {"tracks": stream.partial(slot)}
        stream = None
        prog.close()
        audio_s = sum(c["frames"] for c in calls) * hop
        run.e2e["audio_s_per_s"] = audio_s / run.window_s
        run.counters.update(
            calls=calls, audio_s=audio_s, requests=prog.requests,
            context_frames=mix["context_frames"],
            positions=mix["context_frames"] // 2,
            **{k.split(".")[1]: after[k] - before[k] for k in COUNTERS})
        checked = check_sample(seed, served, deadline_key,
                               mix["check_requests"])
        W, prog.weights = prog.weights, None
        ref = _reference(checked, served, pool, W, cell, device)
        got = [dict(served[key]["out"], ended=served[key]["ended"])
               for key in checked]
        run.readings, faults = readings(
            got, ref, cell.limits["smooth_gap"]["limit"])
        run.faults += faults
        run.counters["checked"] = [
            {"seconds": served[key]["seconds"],
             "chunks": served[key]["chunks"], "ended": served[key]["ended"]}
            for key in checked]
        if with_controls:
            limit = cell.limits["smooth_gap"]["limit"]
            ended = [served[key]["ended"] for key in checked]
            run.counters["controls"] = {
                name: readings([dict(r, ended=e) for r, e in zip(
                    _reference(checked, served, pool, W, cell, device, **kw),
                    ended)], ref, limit)[0]
                for name, kw in (("tf32", {"tf32": True}),
                                 ("reset", {"reset": True}))}
    return run
