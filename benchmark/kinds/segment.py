"""Segmentation of long broadcasts, as ``cli/segment.py::main`` serves
one: ``read_audio``, ``_featurize_broadcast`` (K1 or K2, slabbed past
16384 frames), then ``segmenter(...).segment`` (``StreamingSegmenter``:
chunks of shift-1 windows through the model, the tracks back to the host,
the S track median-smoothed).  The model is built and given its weights
once in set-up, as a long-lived indexing process holds it.

One client in a closed loop: the pool's broadcasts are served back to
back in seeded permutations until ``--seconds`` have passed; the request
then in progress completes and counts.  Set-up serves the pool's longest
and shortest broadcast once (every slab shape, the longest chunks, and
the bucketed path of short broadcasts).  A traced run profiles the
requests that start in the window's last ``trace_seconds``.

The check: from the requests the window completed, the longest and the
shortest broadcast and others drawn from the seed, up to
``check_requests`` distinct ones; the reference reads the same wav and
recomputes every track, the smoothed S track and the labels.  Compared:
the largest gap of any head's track, of the smoothed track, and the
labels that differ where the reference's smoothed value lies farther
from 0.5 than the smoothed track's limit.
"""

from __future__ import annotations

import contextlib
import gc
import os
import tempfile
import time

import numpy as np
import torch

from .. import harness
from ..reference import frontend as ref_frontend
from ..reference import segment as ref_segment
from ..trace import Profiler
from ..traffic import generate


def serve_settings(cell: harness.Cell) -> dict:
    mix = cell.mix
    return {"patch_size": mix["patch_size"],
            "chunk_frames": mix["chunk_frames"],
            "smooth_win": mix["smooth_win"],
            "slab_threshold": mix["slab_threshold"],
            "reference_batch": cell.config["reference_batch"]}


class SegmentCell:
    """The program's segmenter for one cell, with its model's weights."""

    def __init__(self, cell: harness.Cell, seed: int, device, spans):
        from sm_hpss_mtl_tpu_torch.cli.segment import segmenter
        from sm_hpss_mtl_tpu_torch.models.zoo import get_model
        from sm_hpss_mtl_tpu_torch.train.config import MODEL_PRESETS
        cfg, mix = cell.config, cell.mix
        self.device, self.mix, self.spans = device, mix, spans
        with torch.device(device):
            net = get_model(cfg["model"], patch_size=mix["patch_size"])
        self.weights = harness.seeded_weights(net, seed, device, cfg)
        net.load_state_dict(self.weights)
        self.net = net.to(device).eval()
        self.preset = MODEL_PRESETS[cfg["model"]]
        self.seg = segmenter(cfg["model"], self.net,
                             patch_size=mix["patch_size"],
                             chunk_frames=mix["chunk_frames"])

    def request(self, path: str) -> dict:
        from sm_hpss_mtl_tpu_torch.cli.segment import _featurize_broadcast
        from sm_hpss_mtl_tpu_torch.data.audio import read_audio
        with self.spans("read_audio"):
            x, _ = read_audio(path)
        with self.spans("featurize", sync=True):
            fv = _featurize_broadcast(x, self.preset, self.device)
        with self.spans("segment"):
            sm, labels, tracks = self.seg.segment(
                fv, head=self.mix["head"], smooth_win=self.mix["smooth_win"])
        return {"n_samples": len(x), "smoothed": sm, "labels": labels,
                "tracks": tracks}

    def close(self) -> None:
        self.net = self.seg = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class _TimedSmoothing:
    """In a traced run, a span around the segmenter's smoothing."""

    def __init__(self, spans):
        import sm_hpss_mtl_tpu_torch.eval.segment as module
        self.module, self.spans = module, spans
        self.original = module.smooth_predictions

    def __enter__(self):
        original, spans = self.original, self.spans

        def smooth_predictions(*args, **kwargs):
            with spans("smooth"):
                return original(*args, **kwargs)
        self.module.smooth_predictions = smooth_predictions

    def __exit__(self, *exc):
        self.module.smooth_predictions = self.original


def check_sample(seed: int, done: dict, pool: list, k: int) -> list[int]:
    """Pool indices to check: the longest and the shortest broadcast the
    window completed, then others drawn from the seed, ``k`` in all."""
    idx = sorted(done, key=lambda i: pool[i]["seconds"])
    first = [idx[-1], idx[0]] if len(idx) > 1 else idx
    rest = [i for i in idx if i not in first]
    rng = np.random.default_rng([seed, 2])
    rng.shuffle(rest)
    return (first + rest)[:k]


def readings(prog: list, ref: list, smooth_limit: float) -> tuple[dict, list]:
    """The compared numbers over the checked requests, and faults."""
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
        if p["smoothed"].shape != r["smoothed"].shape:
            faults.append("smoothed track: wrong length")
            continue
        smooth = max(smooth, float(np.abs(p["smoothed"]
                                          - r["smoothed"]).max()))
        clear = np.abs(r["smoothed"] - 0.5) > smooth_limit
        flips += int(((p["labels"] != r["labels"]) & clear).sum())
    return ({"track_gap": track, "smooth_gap": smooth, "label_flips": flips},
            faults)


def controls(ref: list, requests: list, weights: dict, cell: harness.Cell,
             device) -> dict:
    """The readings of the control: the reference with TF32 products in
    the program's place, against the reference.  Not part of a benchmark
    run."""
    low = [ref_segment.segment(r["path"], weights, cell.config,
                               serve_settings(cell), device, tf32=True)
           for r in requests]
    return {"tf32": readings(low, ref, cell.limits["smooth_gap"]["limit"])[0]}


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, card: dict,
        with_controls: bool = False) -> harness.Run:
    mix, feat = cell.mix, cell.config["features"]
    run = harness.Run(cell=cell, card=card,
                      spans=harness.Spans(traced))
    with tempfile.TemporaryDirectory(prefix="bench-segment-") as root:
        pool = generate.make_pool(os.path.join(root, "pool"), seed,
                                  mix["pool"])
        run.setup.mark("pool")
        prog = SegmentCell(cell, seed, device, run.spans)
        run.setup.mark("model")
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
                    "windows": T - mix["patch_size"] + 1,
                    "traced": profiler is not None and profiler.active})
                done.setdefault(i, out)
            harness.sync(device)
            run.window_s = time.perf_counter() - t0
        if profiler is not None and profiler.active:
            profiler.stop()
            run.trace = profiler.summary
        run.memory_peak_bytes = harness.memory_peak(device)
        prog.close()
        audio_s = sum(r["n_samples"] for r in requests) / feat["sr"]
        run.e2e["audio_s_per_s"] = audio_s / run.window_s
        if requests:
            run.e2e["request_p95_ms"] = float(
                np.percentile([r["ms"] for r in requests], 95))
        run.counters.update(requests=requests, audio_s=audio_s)
        checked = check_sample(seed, done, pool, mix["check_requests"])
        settings = serve_settings(cell)
        ref = [ref_segment.segment(pool[i]["path"], prog.weights,
                                   cell.config, settings, device)
               for i in checked]
        run.readings, faults = readings(
            [done[i] for i in checked], ref,
            cell.limits["smooth_gap"]["limit"])
        run.faults += faults
        run.counters["checked"] = [pool[i]["seconds"] for i in checked]
        if with_controls:
            run.counters["controls"] = controls(ref, [pool[i] for i in checked],
                                                prog.weights, cell, device)
    return run
