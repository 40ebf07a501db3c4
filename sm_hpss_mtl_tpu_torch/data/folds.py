"""Cross-validation folds of a MUSAN-layout corpus (a copy of
``sm_hpss_mtl_tpu/data/folds.py``).

Files are assigned to ``cv`` folds round-robin within each annotation
stratum (music genre, speech gender), and each fold of the mixture classes
(speech+music, speech+noise) pairs files of that fold at random while
cycling the SMR through ``mixing_db`` (-5..20 dB in 1 dB steps by
default).  The structure is the reference's ``cv_file_list`` dict:
per-class ``fold{k}`` lists, pair dicts with 'speech'/'music'/'SMR',
``filewise_duration``, ``total_duration`` in hours and ``dataset_size``.
"""

from __future__ import annotations

import csv
import os
import pickle

import numpy as np

from .audio import duration_seconds

DEFAULT_MIXING_DB = list(range(-5, 21))


def read_annotations(annot_dir: str, class_name: str
                     ) -> list[tuple[str, str]]:
    """Rows of ``<class>.csv`` as (file_stem, stratum) pairs; a missing file
    gives an empty list (the caller then uses one stratum)."""
    path = os.path.join(annot_dir, class_name + ".csv")
    if not os.path.exists(path):
        return []
    out = []
    with open(path, newline="\n") as f:
        for row in csv.reader(f, delimiter=",", quotechar="|"):
            if not row:
                continue
            out.append((row[0], row[1] if len(row) > 1 else "no_annot"))
    return out


def _stratified_folds(entries: list[tuple[str, str]], cv: int,
                      existing_dir: str,
                      division: dict | None = None) -> dict:
    """Round-robin fold assignment within each stratum, in annotation-file
    order.  ``division`` collects ``{stratum: {foldK: [files]}}``."""
    folds = {f"fold{k}": [] for k in range(cv)}
    last = {}
    for stem, stratum in entries:
        wav = stem + ".wav"
        if existing_dir and not os.path.exists(os.path.join(existing_dir,
                                                            wav)):
            continue
        last[stratum] = 0 if stratum not in last else (last[stratum] + 1) % cv
        fold = f"fold{last[stratum]}"
        folds[fold].append(wav)
        if division is not None:
            division.setdefault(stratum,
                                {f"fold{k}": [] for k in range(cv)}
                                )[fold].append(wav)
    return folds


def _pair_folds(folds_a: dict, folds_b: dict, key_a: str, key_b: str,
                cv: int, mixing_db: list[int],
                rng: np.random.Generator) -> dict:
    """Random pairing with re-shuffled replacement and SMR cycling; pairs
    per fold = the size of the larger constituent fold."""
    out = {}
    for k in range(cv):
        fold = f"fold{k}"
        out[fold] = []
        a = list(folds_a[fold])
        b = list(folds_b[fold])
        rng.shuffle(a)
        rng.shuffle(b)
        db_idx = 0
        if not folds_a[fold] or not folds_b[fold]:
            continue
        for _ in range(max(len(folds_a[fold]), len(folds_b[fold]))):
            if not a:
                a = list(folds_a[fold])
                rng.shuffle(a)
            if not b:
                b = list(folds_b[fold])
                rng.shuffle(b)
            out[fold].append({key_a: a.pop(), key_b: b.pop(),
                              "SMR": mixing_db[db_idx]})
            db_idx = (db_idx + 1) % len(mixing_db)
    return out


def measure_durations(folder: str, class_names) -> tuple[dict, dict]:
    """Per-class total and per-file durations in seconds."""
    total, filewise = {}, {}
    for cls in class_names:
        total[cls] = 0.0
        filewise[cls] = {}
        d = os.path.join(folder, cls)
        for fn in sorted(os.listdir(d)):
            if not fn.endswith(".wav"):
                continue
            dur = duration_seconds(os.path.join(d, fn))
            filewise[cls][fn] = dur
            total[cls] += dur
    return total, filewise


def create_cv_folds(folder: str, *, annot_dir: str | None = None,
                    cv: int = 3, with_noise: bool = False,
                    mixing_db: list[int] | None = None,
                    seed: int = 0) -> dict:
    """The ``cv_file_list`` structure for a MUSAN-layout corpus."""
    mixing_db = mixing_db or DEFAULT_MIXING_DB
    rng = np.random.default_rng(seed)
    annot_dir = annot_dir or os.path.join(folder, "annotations")
    base_classes = ["music", "speech"] + (["noise"] if with_noise else [])

    cv_file_list = {"CV_folds": cv,
                    "dataset_name": os.path.basename(os.path.normpath(folder))}
    divisions = {}
    for cls in base_classes:
        entries = read_annotations(annot_dir, cls)
        if not entries:
            entries = [(fn[:-4], "no_annot")
                       for fn in sorted(os.listdir(os.path.join(folder, cls)))
                       if fn.endswith(".wav")]
        divisions[cls] = {}
        cv_file_list[cls] = _stratified_folds(entries, cv,
                                              os.path.join(folder, cls),
                                              division=divisions[cls])
    cv_file_list["_divisions"] = divisions

    cv_file_list["speech+music"] = _pair_folds(
        cv_file_list["speech"], cv_file_list["music"], "speech", "music",
        cv, mixing_db, rng)
    if with_noise:
        cv_file_list["speech+noise"] = _pair_folds(
            cv_file_list["speech"], cv_file_list["noise"], "speech", "noise",
            cv, mixing_db, rng)

    total, filewise = measure_durations(folder, base_classes)
    cv_file_list["filewise_duration"] = filewise
    cv_file_list["total_duration"] = dict(total)
    cv_file_list["total_duration"]["speech+music"] = max(total.values())
    if with_noise:
        cv_file_list["total_duration"]["speech+noise"] = max(total.values())
    for k in cv_file_list["total_duration"]:
        cv_file_list["total_duration"][k] /= 3600.0
    cv_file_list["dataset_size"] = sum(cv_file_list["total_duration"].values())
    return cv_file_list


def get_train_test_files(cv_file_list: dict, fold: int,
                         class_names=None) -> tuple[dict, dict]:
    """Fold ``fold`` is the test set, all others the training set."""
    class_names = class_names or ["music", "speech", "speech+music"]
    cv = cv_file_list["CV_folds"]
    train, test = {}, {}
    for cls in class_names:
        train[cls], test[cls] = [], []
        for k in range(cv):
            files = cv_file_list[cls][f"fold{k}"]
            (test if k == fold else train)[cls].extend(files)
    return train, test


def save_cv_folds(cv_file_list: dict, op_dir: str) -> None:
    """``cv_file_list.pkl`` and the reference's sidecars: ``details.txt``,
    ``Dataset_Duration.pkl``, the per-stratum division pickles and a
    ``fold{k}.csv`` per fold."""
    os.makedirs(op_dir, exist_ok=True)
    with open(os.path.join(op_dir, "cv_file_list.pkl"), "wb") as f:
        pickle.dump(cv_file_list, f, pickle.HIGHEST_PROTOCOL)
    with open(os.path.join(op_dir, "details.txt"), "w",
              encoding="utf8") as f:
        for key in cv_file_list:
            f.write(f"{key}: {cv_file_list[key]}\n\n\n")
    with open(os.path.join(op_dir, "Dataset_Duration.pkl"), "wb") as f:
        pickle.dump({"total_duration": cv_file_list.get("total_duration", {}),
                     "filewise_duration":
                         cv_file_list.get("filewise_duration", {})},
                    f, pickle.HIGHEST_PROTOCOL)
    names = {"music": "music_genre_division",
             "speech": "speech_gender_division",
             "noise": "noise_division"}
    for cls, div in cv_file_list.get("_divisions", {}).items():
        with open(os.path.join(op_dir, names.get(cls, cls + "_division")
                               + ".pkl"), "wb") as f:
            pickle.dump(div, f, pickle.HIGHEST_PROTOCOL)
    has_noise = "speech+noise" in cv_file_list
    for k in range(cv_file_list["CV_folds"]):
        rows_per_cls = {}
        cols = ["music", "speech", "speech+music"] + (
            ["noise", "speech+noise"] if has_noise else [])
        for cls in cols:
            fold_files = cv_file_list[cls][f"fold{k}"]
            rows_per_cls[cls] = [
                (f"{fl['speech']}+{fl.get('music', fl.get('noise'))}"
                 f"@{fl['SMR']}dB") if isinstance(fl, dict) else fl
                for fl in fold_files]
        n_rows = max(len(v) for v in rows_per_cls.values())
        with open(os.path.join(op_dir, f"fold{k}.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            for i in range(n_rows):
                w.writerow([rows_per_cls[c][i] if i < len(rows_per_cls[c])
                            else "" for c in cols])


def load_cv_folds(op_dir: str) -> dict:
    """Read back the ``cv_file_list.pkl`` that :func:`save_cv_folds`
    wrote (a pickle: load only folds this program wrote)."""
    with open(os.path.join(op_dir, "cv_file_list.pkl"), "rb") as f:
        return pickle.load(f)
