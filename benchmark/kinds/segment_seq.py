"""Sequence labelling of long broadcasts, as ``cli/segment.py::main``
serves a sequence model (Whisper-MTL): ``read_audio``,
``_featurize_broadcast`` (K1, slabbed past 16384 frames), then
``segmenter(...).segment`` in its 'sequence' mode (consecutive 30-s
contexts, up to 8 a model call, one output per position expanded to its
frames, the tracks back to the host, the S track median-smoothed).  The
model is built and given its weights once in set-up.

One client in a closed loop over the segment mix's pool, as
``segment.py``; set-up serves the longest and the shortest broadcast and
runs the model once at every number of contexts a call can hold.  The
counters ``segment.contexts`` and ``segment.padded_frames`` are read over
the window.  A request's ``windows`` are its real frames over a context's
frames, so that the FLOP count of a context is that of real audio.

The check is ``segment.py``'s over up to ``check_requests`` broadcasts:
the reference (``reference/segment_seq.py``) reads the same wav and
recomputes every track, the smoothed S track and the labels.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

from .. import harness
from ..reference import frontend as ref_frontend
from ..reference import segment_seq as ref_segment_seq
from ..trace import Profiler
from ..traffic import generate
from .segment import SegmentCell, _TimedSmoothing, check_sample, readings

COUNTERS = ("segment.contexts", "segment.padded_frames")


def serve_settings(cell: harness.Cell) -> dict:
    mix = cell.mix
    return {"context_frames": mix["context_frames"],
            "smooth_win": mix["smooth_win"],
            "slab_threshold": mix["slab_threshold"],
            "reference_batch": cell.config["reference_batch"]}


class SequenceCell(SegmentCell):
    """The program's sequence segmenter for one cell, with its model's
    weights; requests as ``SegmentCell``'s."""

    def __init__(self, cell: harness.Cell, seed: int, device, spans):
        from sm_hpss_mtl_tpu_torch.cli.segment import segmenter
        from sm_hpss_mtl_tpu_torch.models.zoo import get_model
        from sm_hpss_mtl_tpu_torch.train.config import MODEL_PRESETS
        cfg = cell.config
        self.device, self.mix, self.spans = device, cell.mix, spans
        with torch.device(device):
            net = get_model(cfg["model"], n_mels=cfg["features"]["n_mels"],
                            **cfg["program"]["arch_kwargs"])
        self.weights = harness.seeded_weights(net, seed, device, cfg)
        net.load_state_dict(self.weights)
        self.net = net.to(device).eval()
        self.preset = MODEL_PRESETS[cfg["model"]]
        self.seg = segmenter(cfg["model"], self.net)
        if self.seg.context_frames != cell.mix["context_frames"]:
            raise ValueError(f"the model takes {self.seg.context_frames}-"
                             f"frame contexts, the mix "
                             f"{cell.mix['context_frames']}")

    def warm_calls(self) -> None:
        """The model once at every number of contexts a call holds."""
        D = self.net.conv1.in_channels
        with torch.inference_mode():
            for n in range(1, self.seg.batch_windows + 1):
                self.net(torch.zeros(n, D, self.seg.context_frames,
                                     device=self.device))


def _counters() -> dict:
    from sm_hpss_mtl_tpu_torch.utils import profiling
    read = getattr(profiling, "counters", None)
    c = read() if read is not None else {}
    return {k: c.get(k, 0) for k in COUNTERS}


def controls(ref: list, requests: list, weights: dict, cell: harness.Cell,
             device) -> dict:
    """The readings of the control: the reference with TF32 products in
    the program's place, against the reference.  Not part of a benchmark
    run."""
    low = [ref_segment_seq.segment(r["path"], weights, cell.config,
                                   serve_settings(cell), device, tf32=True)
           for r in requests]
    return {"tf32": readings(low, ref, cell.limits["smooth_gap"]["limit"])[0]}


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, card: dict,
        with_controls: bool = False) -> harness.Run:
    mix, feat = cell.mix, cell.config["features"]
    L = mix["context_frames"]
    run = harness.Run(cell=cell, card=card, spans=harness.Spans(traced))
    with tempfile.TemporaryDirectory(prefix="bench-segment-seq-") as root:
        prog = SequenceCell(cell, seed, device, run.spans)
        run.setup.mark("model")
        pool = generate.make_pool(os.path.join(root, "pool"), seed,
                                  mix["pool"])
        run.setup.mark("pool")
        prog.warm_calls()
        for i in (len(pool) - 1, 0):
            prog.request(pool[i]["path"])
        run.spans.records.clear()
        order = generate.request_order(seed, len(pool))
        profiler = Profiler() if traced else None
        if profiler is not None:
            profiler.prime()
        run.setup.mark("warmup")
        trace_from = max(0.0, seconds - mix["trace_seconds"])
        done: dict[int, dict] = {}
        requests = []
        smoothing = (_TimedSmoothing(run.spans) if traced
                     else contextlib.nullcontext())
        with smoothing:
            harness.sync(device)
            before = _counters()
            run.window_start = time.time()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                if profiler is not None and not profiler.active \
                        and time.perf_counter() - t0 >= trace_from:
                    profiler.start()
                i = next(order)
                t_req = time.perf_counter()
                run.attempted += 1
                try:
                    with run.spans("request"):
                        out = prog.request(pool[i]["path"])
                except Exception as e:  # a request that never answers
                    run.failed += 1
                    run.faults.append(f"request {i}: {type(e).__name__}: {e}")
                    continue
                T = ref_frontend.n_frames(out["n_samples"], feat["n_fft"],
                                          feat["hop_length"])
                requests.append({
                    "ms": 1e3 * (time.perf_counter() - t_req),
                    "n_samples": out["n_samples"], "frames": T,
                    "windows": T / L, "contexts": -(-T // L),
                    "traced": profiler is not None and profiler.active})
                done.setdefault(i, out)
            harness.sync(device)
            run.window_s = time.perf_counter() - t0
            after = _counters()
        if profiler is not None and profiler.active:
            profiler.stop()
            run.trace = profiler.summary
        run.memory_peak_bytes = harness.memory_peak(device)
        prog.close()
        audio_s = sum(r["n_samples"] for r in requests) / feat["sr"]
        run.e2e["audio_s_per_s"] = audio_s / run.window_s
        run.counters.update(
            requests=requests, audio_s=audio_s, context_frames=L,
            **{k.split(".")[1]: after[k] - before[k] for k in COUNTERS})
        checked = check_sample(seed, done, pool, mix["check_requests"])
        settings = serve_settings(cell)
        ref = [ref_segment_seq.segment(pool[i]["path"], prog.weights,
                                       cell.config, settings, device)
               for i in checked]
        run.readings, faults = readings(
            [done[i] for i in checked], ref,
            cell.limits["smooth_gap"]["limit"])
        run.faults += faults
        run.counters["checked"] = [pool[i]["seconds"] for i in checked]
        if with_controls:
            run.counters["controls"] = controls(
                ref, [pool[i] for i in checked], prog.weights, cell, device)
    return run
