"""Streaming segmentation entry point: long-audio speech/music detection.

Counterpart of ``python -m sm_hpss_mtl_tpu.cli.segment``: featurize a
broadcast on the GPU (kernel K1 for the Mel-HPSS features of the Lemaire
MTL models and Doukhan-MTL, kernel K2 for the full-resolution ones of
Jang-MTL and Papakostas-MTL), run shift-1 windows of the model over it in
chunks (Whisper-MTL: consecutive 30-s contexts, labelled per frame;
Granite-Hybrid-MTL: the same chunks streamed through one slot of a causal
model whose state carries from one chunk to the next),
median-smooth the S or M track, optionally score against an interval CSV,
and write per-frame labels.

    python -m sm_hpss_mtl_tpu_torch.cli.segment broadcast.wav \\
        --ckpt results/.../fold0_ckpt [--model Jang_et_al_MTL] [--head S] \\
        [--annot labels.csv] [--out labels.npz]

The model comes from exactly one of ``--ckpt``, a fold checkpoint directory
that ``cli.mtl`` (``train/checkpoint.py``) writes, as the JAX CLI's
``--ckpt``, and ``--weights``, an ``.npz`` of the flax variable tree with
``/``-joined keys (``sm_hpss_mtl_tpu_torch.weights``); Whisper-MTL's, which
has no flax counterpart, holds its ``state_dict`` keys
(``weights.save_state_npz``).  The JAX package's
orbax checkpoints are refused: the port reads its own.  The input is a wav
or an mp3 (``data/audio.py::read_audio``).  The model serves in float32
whatever precision it was trained in, as the JAX CLI's.  Runs on CUDA
unless ``--device cpu`` is given.  With several GPUs visible, the Mel-HPSS
features of a broadcast of at least 20 frames a GPU are computed
time-sharded over all of them (``parallel.featuregram_time_sharded``: K1
in halo mode on each), as the JAX CLI shards over its devices.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.audio import read_audio
from ..data.featurize import _reflect_pad_to, bucket_length
from ..device import resolve_device
from ..eval.metrics import get_performance
from ..eval.segment import (StreamingSegmenter,
                            interval_annotations_to_markers,
                            read_interval_csv)
from ..models.zoo import (IMAGE_BATCH_WINDOWS, INPUT_KIND, MTL,
                          SEQUENCE_BATCH_CONTEXTS, load_model)
from ..ops.featuregram import _parse, featuregram, featuregram_slabbed
from ..ops.stft import n_frames
from ..parallel import Mesh, featuregram_time_sharded
from ..train.checkpoint import model_npz
from ..train.config import MODEL_PRESETS, SERVED_KINDS, preset_n_mels
from ..utils.profiling import request, span

#: Models this entry point serves: the MTL models with S and M heads that
#: take one featuregram.
MODELS = ("Lemaire_et_al_MTL", "Lemaire_et_al_Cascaded_MTL",
          "Lemaire_et_al_MTL_5class", "Jang_et_al_MTL",
          "Papakostas_et_al_MTL", "Doukhan_et_al_MTL", "Whisper_MTL",
          "Granite_Hybrid_MTL")

#: Broadcasts longer than this many frames featurize through
#: ``featuregram_slabbed``, as in the JAX CLI.
SLAB_THRESHOLD_FRAMES = 16384


def _featurize_broadcast(x: np.ndarray, preset: dict, device: torch.device,
                         devices=None) -> torch.Tensor:
    """Featuregram ``(D, T)`` of a whole broadcast, on ``device``.

    ``devices`` (default: every visible GPU on CUDA, ``[device]`` on the
    CPU): with more than one, a Mel-HPSS featName and at least 20 frames a
    device, the time axis is sharded over them through the fused front
    end's halo mode, as in the JAX CLI; a device may repeat.  The span
    ``segment.featurize`` counts the frames; it ends when the last launch
    is queued (no synchronise)."""
    kw = dict(feat_name=preset["feat_name"], n_fft=preset["n_fft"],
              n_mels=preset_n_mels(preset))
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" else [device])
    _, is_mel, harm, perc = _parse(preset["feat_name"])
    n_dev = len(devices)
    true_t = n_frames(len(x), preset["n_fft"], 160)
    with span("segment.featurize", n=true_t):
        if n_dev > 1 and is_mel and (harm or perc) and true_t // n_dev >= 20:
            mesh = Mesh(devices, ("time",))
            return featuregram_time_sharded(
                torch.as_tensor(np.asarray(x, np.float32), device=device),
                mesh, **kw)
        if true_t > SLAB_THRESHOLD_FRAMES:
            return featuregram_slabbed(
                torch.as_tensor(np.asarray(x, np.float32), device=device),
                **kw)
        # Short files: pad to the same length bucket as the JAX CLI, so
        # both featurize the same signal; the clamp sees only real frames.
        x = _reflect_pad_to(np.asarray(x, np.float32), bucket_length(len(x)))
        fv = featuregram(torch.as_tensor(x, device=device),
                         valid_frames=true_t, **kw)
        return fv[:, :true_t]


def check_model(name: str) -> None:
    """Raise unless ``name`` is a model this entry point serves: a
    single-task model has no S or M head to segment by, and the
    intermediate-fusion model takes two inputs where the segmenter has one
    featuregram (the JAX CLI fails on it too: its template state is built
    from one array, which the model indexes by 'harm_input')."""
    if name == "Lemaire_et_al_MTL_IF":
        raise ValueError(
            f"--model {name}: the intermediate-fusion model takes "
            "{'harm_input', 'perc_input'}, the segmenter feeds one "
            "featuregram; the JAX CLI cannot serve it either (a TypeError "
            "where it indexes an array by 'harm_input')")
    if name in MTL and name not in MODELS:
        raise ValueError(
            f"--model {name}: a single-task model has no S or M head to "
            f"segment by; served: {', '.join(MODELS)}")
    if name not in MODELS:
        raise ValueError(f"--model {name}: unknown model; served: "
                         f"{', '.join(MODELS)}")


def checkpoint_weights(ckpt: str) -> str:
    """The model ``.npz`` of the port's fold checkpoint at ``ckpt``; an
    orbax checkpoint (the JAX package's) or a missing one raises."""
    path = model_npz(ckpt)
    if os.path.exists(path):
        return path
    if os.path.isdir(os.path.dirname(path)):
        raise ValueError(
            f"--ckpt {ckpt}: its state/ holds no model.npz: an orbax "
            "checkpoint of the JAX package, which the port does not read; "
            "the port's checkpoints (cli.mtl) hold state/model.npz")
    raise FileNotFoundError(f"--ckpt {ckpt}: no checkpoint ({path})")


def segmenter(model: str, predict_fn, *, patch_size: int = 68,
              chunk_frames: int = 10000) -> StreamingSegmenter:
    """The streaming segmenter that serves ``model``: its input kind, its
    preset's feature name, and model calls of at most
    ``IMAGE_BATCH_WINDOWS`` windows for 'image' models; for a 'sequence'
    model, contexts of the model's ``context_frames`` in calls of at most
    ``SEQUENCE_BATCH_CONTEXTS``; for a 'stream' model, chunks of its
    ``context_frames`` (a file streams through one slot; several streams
    side by side through the segmenter's ``slots``)."""
    kind = INPUT_KIND[model]
    if kind == "stream":
        return StreamingSegmenter(
            predict_fn=predict_fn, input_kind=kind,
            feat_name=MODEL_PRESETS[model]["feat_name"],
            context_frames=predict_fn.context_frames)
    if kind == "sequence":
        return StreamingSegmenter(
            predict_fn=predict_fn, input_kind=kind,
            feat_name=MODEL_PRESETS[model]["feat_name"],
            batch_windows=SEQUENCE_BATCH_CONTEXTS,
            context_frames=predict_fn.context_frames)
    return StreamingSegmenter(
        predict_fn=predict_fn, patch_size=patch_size,
        chunk_frames=chunk_frames, input_kind=kind,
        feat_name=MODEL_PRESETS[model]["feat_name"],
        batch_windows=IMAGE_BATCH_WINDOWS if kind == "image" else None)


def main(argv=None, *, devices=None):
    """The command line; ``devices`` (a function argument only, not a flag)
    overrides the GPUs the features are sharded over (e.g. ``[cuda:0] *
    4``: four shards on one card)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("audio", help="input wav or mp3 (any length), or a "
                                 "precomputed featuregram .npy with --spec")
    p.add_argument("--spec", action="store_true",
                   help="treat the input as a precomputed (D, T) "
                        "featuregram .npy")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="a fold checkpoint directory of the "
                                    "port (cli.mtl's fold<k>_ckpt)")
    src.add_argument("--weights", help="the model's weights .npz (flax "
                                       "keys)")
    p.add_argument("--model", default=MODELS[0],
                   help=f"one of {', '.join(MODELS)}")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--head", default="S", choices=["S", "M"])
    p.add_argument("--patch-size", type=int, default=68)
    p.add_argument("--chunk-frames", type=int, default=10000)
    p.add_argument("--smooth-win", type=int, default=501)
    p.add_argument("--annot", default=None,
                   help="interval CSV (tmin,dur,label) to score against")
    p.add_argument("--out", default=None, help="save labels npz here")
    args = p.parse_args(argv)

    check_model(args.model)
    if INPUT_KIND[args.model] in SERVED_KINDS:
        for flag, value in (("--patch-size", args.patch_size),
                            ("--chunk-frames", args.chunk_frames)):
            if value != p.get_default(flag[2:].replace("-", "_")):
                raise ValueError(
                    f"{flag} does not apply to --model {args.model}, which "
                    "labels every frame of whole 30-s contexts")
    device = resolve_device(args.device)
    weights = args.weights or checkpoint_weights(args.ckpt)
    preset = MODEL_PRESETS[args.model]
    # One request for the file: its read, featurization and segmentation.
    with request():
        if args.spec:
            fv = torch.as_tensor(np.load(args.audio, allow_pickle=False),
                                 dtype=torch.float32, device=device)
        else:
            x, _ = read_audio(args.audio)
            fv = _featurize_broadcast(x, preset, device, devices)

        model = load_model(weights, device, args.model, args.patch_size)
        seg = segmenter(args.model, model, patch_size=args.patch_size,
                        chunk_frames=args.chunk_frames)
        prob, labels, tracks = seg.segment(fv, head=args.head,
                                           smooth_win=args.smooth_win)
    frac = labels.mean() if len(labels) else 0.0
    print(f"{args.audio}: {len(labels)} frames, "
          f"{args.head}-positive fraction {frac:.3f}")

    if args.annot:
        rows = read_interval_csv(args.annot)
        marker = interval_annotations_to_markers(rows, len(labels))
        conf, prec, rec, f1 = get_performance(labels, marker.astype(int),
                                              [0, 1])
        print(f"frame P/R/F1 vs annotations: {prec} {rec} {f1}")

    if args.out:
        np.savez(args.out, prob=prob, labels=labels,
                 **{f"track_{k}": v for k, v in tracks.items()})
        print("saved:", args.out)
    return prob, labels


if __name__ == "__main__":
    main()
