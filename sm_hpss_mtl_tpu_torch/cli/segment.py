"""Streaming segmentation entry point: long-audio speech/music detection.

Counterpart of ``python -m sm_hpss_mtl_tpu.cli.segment``: featurize a
broadcast on the GPU (kernel K1 for the Mel-HPSS features of the Lemaire
MTL models and Doukhan-MTL, kernel K2 for the full-resolution ones of
Jang-MTL and Papakostas-MTL), run shift-1 windows of the model over it in
chunks, median-smooth the S or M track, optionally score against an
interval CSV, and write per-frame labels.

    python -m sm_hpss_mtl_tpu_torch.cli.segment broadcast.wav \\
        --weights W.npz [--model Jang_et_al_MTL] [--head S] \\
        [--annot labels.csv] [--out labels.npz]

``--weights`` is the port's checkpoint: the flax variable tree as an
``.npz`` of ``/``-joined keys (``sm_hpss_mtl_tpu_torch.weights``).
Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.audio import read_wav
from ..data.featurize import _reflect_pad_to, bucket_length
from ..device import resolve_device
from ..eval.metrics import get_performance
from ..eval.segment import (StreamingSegmenter,
                            interval_annotations_to_markers,
                            read_interval_csv)
from ..models.zoo import IMAGE_BATCH_WINDOWS, INPUT_KIND, MTL, load_model
from ..ops.featuregram import featuregram, featuregram_slabbed
from ..ops.stft import n_frames
from ..train.config import MODEL_PRESETS, preset_n_mels

#: Models this entry point serves: the MTL models with S and M heads that
#: take one featuregram.
MODELS = ("Lemaire_et_al_MTL", "Lemaire_et_al_Cascaded_MTL",
          "Lemaire_et_al_MTL_5class", "Jang_et_al_MTL",
          "Papakostas_et_al_MTL", "Doukhan_et_al_MTL")

#: Broadcasts longer than this many frames featurize through
#: ``featuregram_slabbed``, as in the JAX CLI.
SLAB_THRESHOLD_FRAMES = 16384


def _featurize_broadcast(x: np.ndarray, preset: dict,
                         device: torch.device) -> torch.Tensor:
    """Featuregram ``(D, T)`` of a whole broadcast, on ``device``."""
    kw = dict(feat_name=preset["feat_name"], n_fft=preset["n_fft"],
              n_mels=preset_n_mels(preset))
    true_t = n_frames(len(x), preset["n_fft"], 160)
    if true_t > SLAB_THRESHOLD_FRAMES:
        return featuregram_slabbed(
            torch.as_tensor(np.asarray(x, np.float32), device=device), **kw)
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


def segmenter(model: str, predict_fn, *, patch_size: int = 68,
              chunk_frames: int = 10000) -> StreamingSegmenter:
    """The streaming segmenter that serves ``model``: its input kind, its
    preset's feature name, and model calls of at most
    ``IMAGE_BATCH_WINDOWS`` windows for 'image' models."""
    kind = INPUT_KIND[model]
    return StreamingSegmenter(
        predict_fn=predict_fn, patch_size=patch_size,
        chunk_frames=chunk_frames, input_kind=kind,
        feat_name=MODEL_PRESETS[model]["feat_name"],
        batch_windows=IMAGE_BATCH_WINDOWS if kind == "image" else None)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("audio", help="input wav (any length), or a "
                                 "precomputed featuregram .npy with --spec")
    p.add_argument("--spec", action="store_true",
                   help="treat the input as a precomputed (D, T) "
                        "featuregram .npy")
    p.add_argument("--weights", required=True,
                   help="the model's weights .npz (flax keys)")
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
    device = resolve_device(args.device)
    preset = MODEL_PRESETS[args.model]
    if args.spec:
        fv = torch.as_tensor(np.load(args.audio, allow_pickle=False),
                             dtype=torch.float32, device=device)
    else:
        x, _ = read_wav(args.audio)
        fv = _featurize_broadcast(x, preset, device)

    model = load_model(args.weights, device, args.model, args.patch_size)
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
