"""Long-audio streaming segmentation (the cross-corpus broadcast use case).

Counterpart of ``sm_hpss_mtl_tpu/eval/segment.py`` with the semantics of
its plain Python loop over chunks:

- :func:`interval_annotations_to_markers`: time-interval CSV rows
  (tmin, dur, label) -> per-frame 0/1 markers, positions scaled by the
  total annotated duration as the reference does.
- :class:`StreamingSegmenter`: dense inference over a featuregram of any
  length, in fixed chunks of shift-1 windows, giving per-window S and M
  probability tracks from the MTL heads; or, for a sequence model
  (Whisper-MTL), in consecutive contexts labelled per frame; or, for a
  stream model (Granite-Hybrid-MTL), chunk by chunk through slots whose
  state the model carries (:class:`StreamSlots`).
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
    ``segment.padded_frames`` count the contexts and their padding.

    ``input_kind='stream'`` (Granite-Hybrid-MTL, a causal model whose state
    carries from one call to the next) cuts the featuregram as the
    'sequence' mode does, but feeds the contexts (chunks) one model call
    after another through a slot of :class:`StreamSlots`
    (:meth:`slots`), each chunk after the one before it; a stream's labels
    at any time are those of the audio it has read so far."""
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
        if self.input_kind == "stream":
            with request():
                stream = self.slots(1, fv.device)
                stream.assign(0, None, fv)
                while True:
                    done = stream.step()["finished"]
                    if done:
                        return done[0]["tracks"]
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

    def _standardized_contexts(self, parts: list) -> torch.Tensor:
        """``(n, D, context_frames)`` from featuregram pieces of at most
        ``context_frames`` frames, each standardized over its own frames
        (the 'chunk' scope) and zero-padded after that."""
        L = self.context_frames
        D = parts[0].shape[0]
        batch = parts[0].new_zeros((len(parts), D, L))
        for i, seg in enumerate(parts):
            batch[i, :, :seg.shape[1]] = seg
        if self._scope() != "chunk":
            return batch
        if all(seg.shape[1] == L for seg in parts):
            return self._standardize_parts(batch)
        for i, seg in enumerate(parts):
            batch[i, :, :seg.shape[1]] = self._standardize_parts(
                batch[i, :, :seg.shape[1]])
        return batch

    def slots(self, n: int, device) -> "StreamSlots":
        """``n`` streams of a 'stream' model side by side, on
        ``device``."""
        if self.input_kind != "stream":
            raise ValueError(f"slots are for 'stream' models, not "
                             f"{self.input_kind!r}")
        if self._scope() == "featuregram":
            raise ValueError("a stream is standardized per chunk: it has no "
                             "whole featuregram to standardize over")
        return StreamSlots(self, n, device)

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


@dataclass
class _Slot:
    key: object
    fv: torch.Tensor
    tracks: dict
    fed: int = 0


class StreamSlots:
    """``n`` streams of a 'stream' model (:class:`StreamingSegmenter` in
    its 'stream' mode) through one model call after another.

    :meth:`assign` gives a slot a broadcast's ``(D, T)`` featuregram and
    resets the slot's carried state (``predict_fn.new_state``'s
    ``reset``).  :meth:`step` is
    one model call that advances every busy slot by one chunk of
    ``context_frames`` frames: each chunk standardized over its real
    frames, the last of a broadcast zero-padded after that, all stacked
    ``(n, D, context_frames)``; an idle slot reads zeros, its state reset
    before the call, and its outputs are dropped.  Each head's output per
    position goes to the host and is appended to its broadcast's tracks,
    position ``p`` labelling the chunk's frames ``f p`` to ``f p + f - 1``
    (``f = context_frames / P``), cut to its real frames.  A broadcast
    whose last chunk went through leaves its slot, with its tracks and,
    where :meth:`step` is given a ``head``, that head's track smoothed over
    ``smooth_win`` (:func:`smooth_predictions`) and its labels.

    Each :meth:`step` is one ``utils.profiling.request``; its spans, each
    counting the busy slots: ``segment.assemble``,
    ``segment.standardize``, ``segment.model_call``, ``segment.to_host``,
    and per finished broadcast ``segment.smooth`` (frames); the state's
    resets and key and value appends are ``segment.carry``.  Counters:
    ``segment.stream_chunks`` (chunks of broadcasts fed),
    ``segment.stream_positions`` (their real positions),
    ``segment.padded_frames``, ``segment.state_resets`` (slots given a
    broadcast) and ``segment.kv_positions`` (over the busy slots, the key
    positions each chunk's queries attend: the slot's carried positions
    and the chunk's)."""

    def __init__(self, seg: StreamingSegmenter, n: int, device):
        self.seg = seg
        self.state = seg.predict_fn.new_state(n, device)
        self.slots: list[_Slot | None] = [None] * n

    def free(self) -> list[int]:
        """The slots that hold no broadcast."""
        return [i for i, s in enumerate(self.slots) if s is None]

    def assign(self, slot: int, key, fv: torch.Tensor) -> None:
        """Give ``slot`` the broadcast ``key`` with featuregram ``fv``
        ``(D, T)``, its stream started anew."""
        if fv.shape[1] <= 0:
            raise ValueError("empty featuregram")
        self.state.reset(slot)
        profiling.count("segment.state_resets")
        self.slots[slot] = _Slot(key, fv, {})

    def partial(self, slot: int) -> dict[str, np.ndarray]:
        """The tracks of the chunks ``slot``'s broadcast has had so far."""
        s = self.slots[slot]
        return {k: np.concatenate(v, axis=0) for k, v in s.tracks.items()}

    def step(self, head: str | None = None, smooth_win: int = 501) -> dict:
        """One model call.  Returns ``{"finished": [...], "frames": n}``:
        the broadcasts that ended, each ``{"key", "tracks"}`` (and with a
        ``head``, ``"smoothed"`` and ``"labels"``), and the real frames the
        call read."""
        L = self.seg.context_frames
        busy = [i for i, s in enumerate(self.slots) if s is not None]
        if not busy:
            raise ValueError("no slot holds a broadcast")
        finished = []
        with request():
            for i in self.free():
                self.state.reset(i)
            with span("segment.assemble", n=len(busy)):
                parts = []
                for i in range(len(self.slots)):
                    s = self.slots[i]
                    parts.append(s.fv[:, s.fed:s.fed + L] if s is not None
                                 else None)
                real = [0 if p is None else p.shape[1] for p in parts]
                D = self.slots[busy[0]].fv.shape[0]
                fill = self.slots[busy[0]].fv.new_zeros((D, 1))
                parts = [fill if p is None else p for p in parts]
            with span("segment.standardize", n=len(busy)):
                batch = self.seg._standardized_contexts(parts)
            for i in self.free():
                batch[i].zero_()
            frames = sum(real)
            profiling.count("segment.stream_chunks", len(busy))
            profiling.count("segment.stream_positions",
                            sum(-(-real[i] // 2) for i in busy))
            profiling.count("segment.padded_frames",
                            len(busy) * L - frames)
            with span("segment.model_call", n=len(busy)), \
                    torch.inference_mode():
                out = self.seg.predict_fn(batch, self.state)
            profiling.count("segment.kv_positions",
                            sum(self.state.lengths[i] for i in busy))
            with span("segment.to_host", n=len(busy)):
                host = {k: v.float().cpu().numpy() for k, v in out.items()}
            for i in busy:
                s = self.slots[i]
                for k, v in host.items():
                    per = np.repeat(v[i], L // v.shape[1], axis=0)
                    s.tracks.setdefault(k, []).append(per[:real[i]])
                s.fed += real[i]
                if s.fed < s.fv.shape[1]:
                    continue
                done = {"key": s.key, "tracks": self.partial(i)}
                if head is not None:
                    prob = done["tracks"][head]
                    prob = prob[:, 0] if prob.ndim > 1 else prob
                    with span("segment.smooth", n=len(prob)):
                        done["smoothed"], done["labels"] = \
                            smooth_predictions(prob, smooth_win)
                finished.append(done)
                self.slots[i] = None
        return {"finished": finished, "frames": frames}
