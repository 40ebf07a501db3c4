"""Feature-space visualization: KMeans-compressed t-SNE embeddings
(counterpart of ``sm_hpss_mtl_tpu/cli/tsne.py``, the same flags, plus
``--device``).

The reference's ``draw_tSNE_plots.py``: load per-class feature patches
(the features on the device: K1 or K2 on CUDA; optionally each patch
reduced to its row or column skewness "striation" vector, the paper's
evidence that harmonic striations separate speech from music), compress
each class with KMeans, embed with t-SNE (sklearn, on the host), and save
the embedding (and a scatter plot where matplotlib exists).

    python -m sm_hpss_mtl_tpu_torch.cli.tsne --data corpus --out tsne.npz \\
        [--stat Row|Col] [--clusters 100] [--device cpu]

Runs on CUDA unless ``--device cpu`` is given; without a GPU it raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

import torch

from ..data.featurize import FeatureConfig, Featurizer
from ..data.folds import create_cv_folds, load_cv_folds
from ..device import resolve_device
from ..ops.patches import extract_patches_np, standardize_rows
from ..ops.stats import patch_statistics


def collect_class_patches(featurizer, folder, files_by_class, *,
                          patch_size=68, patch_shift=68, feat_name,
                          stat=None, max_patches_per_class=5000, seed=0):
    """(features, labels) arrays across classes; patches optionally
    reduced to skewness vectors (``draw_tSNE_plots.py:25-223``).  Rows
    are standardized by the port's rule (``ops.patches.standardize_rows``:
    a constant row is centred to 0)."""
    rng = np.random.default_rng(seed)
    feats, labels = [], []
    for label, (cls, files) in enumerate(files_by_class.items()):
        cls_feats = []
        for item in files:
            if isinstance(item, dict):
                sp = os.path.join(folder, "speech", item["speech"])
                mu = os.path.join(folder, "music", item["music"])
                if not (os.path.exists(sp) and os.path.exists(mu)):
                    continue
                fv = featurizer.featuregram("speech_music", sp, mu,
                                            item["SMR"], save_feat=False)
            else:
                sub = "speech" if cls == "speech" else cls
                path = os.path.join(folder, sub, item)
                if not os.path.exists(path):
                    continue
                kw = ({"sp_path": path} if cls == "speech"
                      else {"mu_path": path})
                fv = featurizer.featuregram(cls, **kw, save_feat=False)
            dual = "HarmPerc" in feat_name
            parts = ([fv[:fv.shape[0] // 2], fv[fv.shape[0] // 2:]]
                     if dual else [fv])
            pp = [extract_patches_np(
                standardize_rows(torch.from_numpy(p)).numpy(), patch_size,
                patch_shift) for p in parts]
            patches = np.concatenate(pp, axis=1) if dual else pp[0]
            if stat:
                axis = 1 if stat == "Row" else 0
                patches = patch_statistics(
                    torch.from_numpy(patches), stat_type="skew",
                    axis=axis).numpy()
            else:
                patches = patches.reshape(patches.shape[0], -1)
            cls_feats.append(patches)
        x = np.concatenate(cls_feats, axis=0)
        if len(x) > max_patches_per_class:
            x = x[rng.choice(len(x), max_patches_per_class, replace=False)]
        feats.append(x)
        labels.append(np.full(len(x), label))
    return np.concatenate(feats), np.concatenate(labels)


def kmeans_compress(feats, labels, *, clusters=1000, seed=0, cache=None):
    """Joint standardization then per-class KMeans compression
    (``draw_tSNE_plots.py:414-430``: ``StandardScaler`` on the stacked
    data, then per-class ``KMeans(n_clusters=1000)``).

    ``cache``: optional ``.npz`` path; if it exists the compressed
    centers are loaded instead of recomputed (the reference's
    ``os.path.exists`` pickle guard around its embedding,
    ``draw_tSNE_plots.py:406``), and it is written after a fresh run.
    """
    if cache and os.path.exists(cache):
        z = np.load(cache)
        return z["centers"], z["labels"]
    from sklearn.cluster import KMeans
    mu, sd = feats.mean(axis=0), feats.std(axis=0)
    feats = (feats - mu) / np.where(sd == 0, 1.0, sd)
    centers, center_labels = [], []
    for label in np.unique(labels):
        x = feats[labels == label]
        k = min(clusters, len(x))
        km = KMeans(n_clusters=k, n_init=4, random_state=seed).fit(x)
        centers.append(km.cluster_centers_)
        center_labels.append(np.full(k, label))
    X, y = np.concatenate(centers), np.concatenate(center_labels)
    if cache:
        np.savez(cache, centers=X, labels=y)
    return X, y


def kmeans_tsne(feats, labels, *, clusters=1000, perplexity=30, seed=0,
                cache=None):
    """Per-class KMeans compression then joint t-SNE."""
    from sklearn.manifold import TSNE
    X, y = kmeans_compress(feats, labels, clusters=clusters, seed=seed,
                           cache=cache)
    perplexity = min(perplexity, max(2, len(X) // 4))
    emb = TSNE(n_components=2, perplexity=perplexity,
               random_state=seed).fit_transform(X)
    return emb, y


def grid_search_tsne(X, *, perplexities=range(5, 51, 5),
                     exaggerations=range(2, 15, 2),
                     learning_rates=range(50, 251, 50), seed=0):
    """Hyperparameter grid for the embedding
    (``draw_tSNE_plots.py:275-297``: perplexity 5..50/5, early
    exaggeration 2..14/2, learning rate 50..250/50).  The reference only
    dumps a plot per combination; here each run is scored by its final
    KL divergence and the best setting is returned.

    Returns ``(rows, best)`` where each row has the params + ``kl`` and
    ``best`` additionally carries its ``embedding``.
    """
    from sklearn.manifold import TSNE
    rows, best = [], None
    seen = set()
    for P in perplexities:
        for E in exaggerations:
            for L in learning_rates:
                # Record the perplexity actually run: small sample sets
                # clamp it, and distinct requested values that alias to
                # the same clamp would otherwise be logged as different
                # configurations (and re-run pointlessly).
                P_eff = min(P, max(2, len(X) // 4))
                if (P_eff, E, L) in seen:
                    continue
                seen.add((P_eff, E, L))
                t = TSNE(n_components=2, perplexity=P_eff,
                         early_exaggeration=E, learning_rate=L,
                         random_state=seed)
                emb = t.fit_transform(X)
                row = {"perplexity": P_eff, "early_exaggeration": E,
                       "learning_rate": L,
                       "kl": float(t.kl_divergence_)}
                rows.append(row)
                if best is None or row["kl"] < best["kl"]:
                    best = dict(row, embedding=emb)
    return rows, best


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True)
    p.add_argument("--out", default="tsne.npz")
    p.add_argument("--feat-name", default="LogMelHarmPercSpec")
    p.add_argument("--n-mels", type=int, default=120)
    p.add_argument("--stat", choices=["Row", "Col"], default=None)
    p.add_argument("--patch-size", type=int, default=68)
    p.add_argument("--clusters", type=int, default=1000,
                   help="per-class KMeans size (draw_tSNE_plots.py:359)")
    p.add_argument("--no-cache", action="store_true",
                   help="skip the compressed-features cache next to --out")
    p.add_argument("--max-patches", type=int, default=5000)
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--grid-search", action="store_true",
                   help="sweep perplexity/exaggeration/learning-rate over "
                        "the reference ranges and keep the lowest-KL run")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cv_path = os.path.join(args.data, "cv_info")
    if os.path.exists(os.path.join(cv_path, "cv_file_list.pkl")):
        cv = load_cv_folds(cv_path)
    else:
        cv = create_cv_folds(args.data, seed=args.seed)
    files_by_class = {
        "music": cv["music"][f"fold{args.fold}"],
        "speech": cv["speech"][f"fold{args.fold}"],
        "speech_music": cv["speech+music"][f"fold{args.fold}"],
    }
    fz = Featurizer(FeatureConfig(feat_name=args.feat_name,
                                  n_mels=args.n_mels), device=device)
    feats, labels = collect_class_patches(
        fz, args.data, files_by_class, patch_size=args.patch_size,
        patch_shift=args.patch_size, feat_name=args.feat_name,
        stat=args.stat, max_patches_per_class=args.max_patches,
        seed=args.seed)
    cache = (None if args.no_cache
             else os.path.splitext(args.out)[0] + "_compressed.npz")
    if args.grid_search:
        X, y = kmeans_compress(feats, labels, clusters=args.clusters,
                               seed=args.seed, cache=cache)
        rows, best = grid_search_tsne(X, seed=args.seed)
        emb = best["embedding"]
        from ..utils.results import append_results
        out_dir = os.path.dirname(os.path.abspath(args.out))
        for row in rows:
            append_results(out_dir, args.fold, row, suffix="tSNE_grid")
        print("best t-SNE params:",
              {k: v for k, v in best.items() if k != "embedding"})
    else:
        emb, y = kmeans_tsne(feats, labels, clusters=args.clusters,
                             seed=args.seed, cache=cache)
    np.savez(args.out, embedding=emb, labels=y,
             class_names=list(files_by_class))
    print(f"saved {len(emb)} embedded points -> {args.out}")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(6, 6))
        for label, name in enumerate(files_by_class):
            m = y == label
            ax.scatter(emb[m, 0], emb[m, 1], s=8, label=name, alpha=0.7)
        ax.legend()
        png = os.path.splitext(args.out)[0] + ".png"
        fig.savefig(png, dpi=150, bbox_inches="tight")
        print("plot:", png)
    except ImportError:
        pass
    return emb, y


if __name__ == "__main__":
    main()
