"""Long-audio streaming segmentation (the cross-corpus broadcast use case).

Counterpart of ``sm_hpss_mtl_tpu/eval/segment.py`` with the semantics of
its plain Python loop over chunks:

- :func:`interval_annotations_to_markers`: time-interval CSV rows
  (tmin, dur, label) -> per-frame 0/1 markers, positions scaled by the
  total annotated duration as the reference does.
- :class:`StreamingSegmenter`: dense inference over a featuregram of any
  length, in fixed chunks of shift-1 windows, giving per-window S and M
  probability tracks from the MTL heads; or, for a sequence model
  (Whisper-MTL), in consecutive contexts labelled per frame.
- :func:`smooth_predictions`: median smoothing of a probability track;
  :func:`mode_filtering`: sliding-mode smoothing of a label track.

The featuregram stays on its device; windows are ``Tensor.unfold`` views
of each chunk, and only the probability tracks come back to the host.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from scipy.signal import medfilt

from ..ops.patches import standardize_rows
from ..utils import profiling
from ..utils.profiling import request, span


def interval_annotations_to_markers(rows, n_frames: int,
                                    audio_length: float | None = None
                                    ) -> np.ndarray:
    """``rows``: iterable of (tmin_seconds, duration_seconds, label);
    returns a 0/1 marker of length ``n_frames`` set where label==1.
    Positions are scaled by the total annotated duration (max tmin+dur
    over rows unless ``audio_length`` is given)."""
    rows = [(float(t), float(d), int(l)) for t, d, l in rows]
    if audio_length is None:
        audio_length = max((t + d for t, d, _ in rows), default=0.0)
    marker = np.zeros(n_frames)
    if audio_length <= 0:
        return marker
    for tmin, dur, label in rows:
        if dur == 0.0 or label != 1:
            continue
        tmax = tmin + dur
        start = max(0, int(np.floor(tmin / audio_length * n_frames)))
        end = min(int(np.ceil(tmax / audio_length * n_frames)), n_frames - 1)
        marker[start:end] = 1
    return marker


def read_interval_csv(path: str) -> list[tuple]:
    """DAFx-style CSV: header row then (tmin, dur, label) rows."""
    out = []
    with open(path, newline="\n") as f:
        for i, row in enumerate(csv.reader(f, delimiter=",", quotechar="|")):
            if not row or i == 0:
                continue
            out.append((row[0], row[1], row[2]))
    return out


def mode_filtering(labels: np.ndarray, win_size: int) -> np.ndarray:
    """Sliding-mode smoothing of an integer label track, as the reference's
    loop: position ``i`` takes the most frequent label of
    ``labels[i - half : i + half]`` (the right edge excluded), the smallest
    label on a tie; the first and last ``half`` positions keep theirs.
    Counted per label by cumulative sums."""
    if win_size % 2 == 0:
        win_size += 1
    half = win_size // 2
    n = len(labels)
    out = labels.copy()
    if n <= 2 * half:
        return out
    uniq = np.unique(labels)
    onehot = (labels[None, :] == uniq[:, None]).astype(np.int64)
    cs = np.concatenate([np.zeros((len(uniq), 1), np.int64),
                         np.cumsum(onehot, axis=1)], axis=1)
    idx = np.arange(half, n - half)
    counts = cs[:, idx + half] - cs[:, idx - half]
    out[idx] = uniq[np.argmax(counts, axis=0)]
    return out


def smooth_predictions(prob: np.ndarray, win_size: int = 501
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Median-smooth a probability track and threshold at 0.5."""
    if win_size % 2 == 0:
        win_size += 1
    sm = medfilt(prob, win_size)
    return sm, (sm > 0.5).astype(int)


@dataclass
class StreamingSegmenter:
    """Per-window S/M probabilities over an arbitrarily long featuregram.

    ``standardize`` sets the scope of the per-row standardization (per HPSS
    half for two-part [H; P] features), as the JAX segmenter's:
    ``True``/'chunk' (default) standardizes each chunk of ``chunk_frames``
    windows over the frames its windows cover, the true ragged tail
    included; 'featuregram' the whole recording once; ``False``/'none'
    not at all (the reference's DAFx streaming path).  Each chunk is then
    fed to ``predict_fn`` as time-major ``(count, patch_size, D)`` patches
    (``input_kind='time_mel'``) or as ``(count, D, patch_size, 1)``
    images (``'image'``).  ``batch_windows`` splits a chunk into model
    calls of at most that many windows, for models whose activations
    outgrow the device at a whole chunk (Jang's first conv block holds
    ~2 MB per window); the standardization stays per chunk, so the tracks
    do not depend on it.  A model returning one tensor gives the track
    ``'3C'``.  Each :meth:`segment` or :meth:`frame_probabilities` call is
    one ``utils.profiling.request``; its spans, each counting windows:
    ``segment.standardize``, ``segment.model_call`` (the call that queues
    the model's work), ``segment.to_host`` (the tracks' copies, which wait
    for it) and ``segment.smooth``.

    ``input_kind='sequence'`` (Whisper-MTL) labels every frame instead:
    the featuregram is cut into consecutive contexts of ``context_frames``
    frames, each standardized over its real frames (the 'chunk' scope with
    the context as the chunk), the last zero-padded to the full length
    (zero is the row mean), and up to ``batch_windows`` contexts go through
    the model per call as ``(count, D, context_frames)``.  The model gives
    each head per position, ``(count, P, units)``; position ``p`` labels
    frames ``f p`` to ``f p + f - 1``, ``f = context_frames / P``, and the
    tracks are cut to the featuregram's ``T`` frames.  There the spans
    count contexts, ``segment.assemble`` covers cutting, padding and
    stacking them, and the counters ``segment.contexts`` and
    ``segment.padded_frames`` count the contexts and their padding."""
    predict_fn: Callable[[torch.Tensor], dict]
    patch_size: int = 68
    chunk_frames: int = 10000
    input_kind: str = "time_mel"
    feat_name: str = "LogMelHarmPercSpec"
    batch_windows: int | None = None
    standardize: bool | str = True
    context_frames: int = 3000

    def _scope(self) -> str:
        scope = {True: "chunk", False: "none"}.get(self.standardize,
                                                   self.standardize)
        if scope not in ("chunk", "featuregram", "none"):
            raise ValueError(f"standardize={self.standardize!r}: one of "
                             "True/'chunk', 'featuregram', False/'none'")
        return scope

    def _standardize_parts(self, seg: torch.Tensor) -> torch.Tensor:
        """Rows (axis -2) standardized over the last axis, per HPSS half
        for two-part features."""
        if "HarmPerc" in self.feat_name:
            return torch.cat([standardize_rows(h) for h in seg.chunk(2, -2)],
                             dim=-2)
        return standardize_rows(seg)

    def frame_probabilities(self, fv: torch.Tensor) -> dict[str, np.ndarray]:
        """``fv``: ``(D, T)`` featuregram -> dict of per-window tracks
        (``T - patch_size + 1`` rows; ``T`` for 'sequence') as host
        arrays."""
        if self.input_kind == "sequence":
            return self._sequence_probabilities(fv)
        W = self.patch_size
        n_windows = fv.shape[1] - W + 1
        if n_windows <= 0:
            raise ValueError("featuregram shorter than one window")
        scope = self._scope()
        with request():
            if scope == "featuregram":
                with span("segment.standardize", n=n_windows):
                    fv = self._standardize_parts(fv)
            tracks: dict[str, list] = {}
            start = 0
            while start < n_windows:
                count = min(self.chunk_frames, n_windows - start)
                seg = fv[:, start:start + count + W - 1]
                if scope == "chunk":
                    with span("segment.standardize", n=count):
                        seg = self._standardize_parts(seg)
                wins = seg.unfold(1, W, 1)                 # (D, count, W)
                if self.input_kind == "time_mel":
                    batch = wins.permute(1, 2, 0)          # (count, W, D)
                elif self.input_kind == "image":       # (count, D, W, 1)
                    batch = wins.permute(1, 0, 2)[..., None]
                else:
                    raise ValueError(
                        f"unknown input_kind {self.input_kind!r}")
                self._model_calls(batch, tracks)
                start += count
        return {k: np.concatenate(v, axis=0) for k, v in tracks.items()}

    def _sequence_probabilities(self, fv: torch.Tensor
                                ) -> dict[str, np.ndarray]:
        L = self.context_frames
        D, T = fv.shape
        if T <= 0:
            raise ValueError("empty featuregram")
        scope = self._scope()
        n_ctx = -(-T // L)
        step = self.batch_windows or n_ctx
        tracks: dict[str, list] = {}
        with request():
            if scope == "featuregram":
                with span("segment.standardize", n=n_ctx):
                    fv = self._standardize_parts(fv)
            for c0 in range(0, n_ctx, step):
                n = min(step, n_ctx - c0)
                s, e = c0 * L, min(T, (c0 + n) * L)
                full, tail = divmod(e - s, L)
                with span("segment.assemble", n=n):
                    batch = fv.new_zeros((n, D, L))
                    if full:
                        batch[:full] = fv[:, s:s + full * L].reshape(
                            D, full, L).transpose(0, 1)
                    if tail:
                        batch[full, :, :tail] = fv[:, s + full * L:e]
                profiling.count("segment.contexts", n)
                profiling.count("segment.padded_frames", n * L - (e - s))
                if scope == "chunk":
                    with span("segment.standardize", n=n):
                        if full:
                            batch[:full] = self._standardize_parts(
                                batch[:full])
                        if tail:
                            batch[full, :, :tail] = self._standardize_parts(
                                batch[full, :, :tail])
                self._model_calls(batch, tracks)
        out = {}
        for k, v in tracks.items():
            v = np.concatenate(v, axis=0)              # (n_ctx, P, units)
            out[k] = np.repeat(v.reshape(-1, *v.shape[2:]),
                               L // v.shape[1], axis=0)[:T]
        return out

    def _model_calls(self, batch: torch.Tensor, tracks: dict) -> None:
        """A chunk's windows through the model in calls of at most
        ``batch_windows``; each head's tracks go to ``tracks`` on the
        host."""
        step = self.batch_windows or len(batch)
        for b0 in range(0, len(batch), step):
            part = batch[b0:b0 + step]
            with span("segment.model_call", n=len(part)), \
                    torch.inference_mode():
                out = self.predict_fn(part.contiguous())
            if not isinstance(out, dict):
                out = {"3C": out}
            with span("segment.to_host", n=len(part)):
                for k, v in out.items():
                    tracks.setdefault(k, []).append(v.float().cpu().numpy())

    def segment(self, fv: torch.Tensor, *, head: str = "S",
                smooth_win: int = 501):
        """Smoothed track, 0/1 labels and all raw tracks for one head."""
        with request():
            tracks = self.frame_probabilities(fv)
            prob = (tracks[head][:, 0] if tracks[head].ndim > 1
                    else tracks[head])
            with span("segment.smooth", n=len(prob)):
                sm, labels = smooth_predictions(prob, smooth_win)
        return sm, labels, tracks
