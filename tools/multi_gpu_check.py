#!/usr/bin/env python3
"""The port's multi-device paths across the GPUs of one host, each against
its one-device counterpart (``chip_smoke.py`` phase 11 runs the same paths
on one card, as a mesh of ``cuda:0`` repeated).

    python3 tools/multi_gpu_check.py [--out chiprun_out/multi_gpu.json]

On every visible GPU (N of them, at least 2):

1. ``parallel.stft_hpss_mel_time_sharded`` (mel and full resolution) with
   one shard per GPU, on the production leg of ``MULTICHIP_r05.json`` (2 x
   1536 frames), against one unsharded K1 or K2 launch on GPU 0: K1's bar,
   and the max |delta| at every join;
2. ``cli.segment``'s featurizer of a 10-minute broadcast over the N GPUs
   against GPU 0 alone: 0.02 dB, and the host-clock ms of both;
3. ``fit_multi`` of 2N trials over the N GPUs against the unsharded run on
   GPU 0: each trial at the multi-trial step's bars;
4. data parallelism: N processes over NCCL, one per GPU, joined by a file
   rendezvous (a 120 s timeout on every wait), each with its share of one
   batch of 48 full-width Lemaire-MTL clips: the patch step (on the CPU's
   patches) and the audio step (K1 inside, each process on its own
   clips), against the single step on the whole batch on GPU 0 at the
   patch step's bars; each step's period at world size N, against the
   single step's on GPU 0.

Prints the card line, then one JSON line.  Exits non-zero, printing no
result, if a check fails or fewer than two GPUs are visible.
"""

from __future__ import annotations

import argparse
import copy
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

MODEL = "Lemaire_et_al_MTL"
CLIPS, SAMPLES = 48, 11120
TIMEOUT_S = 120


def _labels(n: int) -> dict:
    """S/M/R/3C labels of ``n`` clips, a third of each class."""
    cls = np.repeat(np.arange(3), n // 3)
    r = np.stack([(cls != 1) * 1.0, (cls != 0) * 1.0], -1).astype(np.float32)
    r[cls == 2, 0] = 10 ** (-5 / 10)
    return {k: torch.from_numpy(v) for k, v in {
        "S": (cls == 1).astype(np.float32),
        "M": (cls == 0).astype(np.float32), "R": r,
        "3C": np.eye(3, dtype=np.float32)[cls]}.items()}


def _batch() -> dict:
    """One batch of seeded crops, their CPU patches and labels, and the
    model's weights (dropout off), on the host."""
    rng = np.random.default_rng(cs.SEED)
    audio = torch.from_numpy(
        (0.1 * rng.standard_normal((CLIPS, SAMPLES))).astype(np.float32))
    net = cs._seeded(MODEL, dropout=False)
    return {"audio": audio, "labels": _labels(CLIPS),
            "patches": cs._patches(audio, MODEL, "cpu"),
            "state": net.state_dict()}


def _step(net, dev, audio: bool, dp: bool):
    """A train step of a copy of ``net`` on ``dev``: the single step or the
    data-parallel one; also the model and its state."""
    from sm_hpss_mtl_tpu_torch.models.zoo import INPUT_KIND
    from sm_hpss_mtl_tpu_torch.parallel import (make_dp_train_step,
                                                per_process_seed)
    from sm_hpss_mtl_tpu_torch.train.endtoend import audio_featurizer
    from sm_hpss_mtl_tpu_torch.train.optimizers import for_model
    from sm_hpss_mtl_tpu_torch.train.state import TrainState
    if not dp:
        model_, state, step, lr = cs._train_setup(str(dev), net, cs.SEED,
                                                  audio=audio)
        return model_, state, step, lr
    model_ = copy.deepcopy(net).to(dev)
    opt, sched = for_model(MODEL, model_.parameters(), tr_steps=100000)
    featurize = (audio_featurizer(cs._feature_config(MODEL), patch_size=68,
                                  patch_shift=68, max_patches=1,
                                  input_kind=INPUT_KIND[MODEL])
                 if audio else None)
    step = make_dp_train_step(
        model_, opt, mtl=True, l2_reg=0.01, featurize=featurize,
        generator=torch.Generator(device=dev).manual_seed(
            per_process_seed(cs.SEED)))
    return model_, TrainState(model_, opt), step, float(sched(0))


def worker(rank: int, world: int, rendezvous: str, inp: str,
           out: str) -> None:
    """One data-parallel process: both steps on its share of the batch."""
    import torch.distributed as dist
    from sm_hpss_mtl_tpu_torch.data.prefetch import to_device
    from sm_hpss_mtl_tpu_torch.parallel import shard_batch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group(
        "nccl", init_method=f"file://{rendezvous}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        data = torch.load(inp)
        net = cs._seeded(MODEL, dropout=False)
        net.load_state_dict(data["state"])
        res = {}
        for kind, batch in (("patch_step", data["patches"]),
                            ("audio_step", data["audio"])):
            model_, state, step, _ = _step(net, dev, kind == "audio_step",
                                           dp=True)
            x, y = shard_batch((batch, data["labels"]))
            x, y = to_device(x, dev), to_device(y, dev)
            loss = float(step(state, x, y)["loss"])
            res[kind] = {"loss": loss, "state": {
                k: v.detach().cpu().clone()
                for k, v in model_.state_dict().items()},
                "step_ms": cs._period_ms(lambda: step(state, x, y))}
        if rank == 0:
            torch.save(res, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dp_checks(world: int, tmp: str) -> dict:
    """Section 4: the processes' steps against the single step on GPU 0."""
    from sm_hpss_mtl_tpu_torch.data.prefetch import to_device
    data = _batch()
    inp, out = os.path.join(tmp, "in.pt"), os.path.join(tmp, "out.pt")
    torch.save(data, inp)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         str(world), os.path.join(tmp, "rendezvous"), inp, out],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=3 * TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        cs.check(p.returncode == 0, f"DP process {r} rc={p.returncode}\n"
                                    f"{so[-3000:]}\n{se[-3000:]}")
    got = torch.load(out)
    net = cs._seeded(MODEL, dropout=False)
    net.load_state_dict(data["state"])
    before = {k: v.clone() for k, v in net.state_dict().items()}
    noise = cs._bn_fed_biases(net)
    dev = torch.device("cuda", 0)
    res = {}
    for kind, batch in (("patch_step", data["patches"]),
                        ("audio_step", data["audio"])):
        model_, state, step, lr = _step(net, dev, kind == "audio_step",
                                        dp=False)
        x, y = to_device(batch, dev), to_device(data["labels"], dev)
        loss = float(step(state, x, y)["loss"])
        single = {k: v.detach().cpu() for k, v in model_.state_dict().items()}
        held = cs._hold_step(f"DP {kind} at world size {world}", before,
                             single, got[kind]["state"], loss,
                             got[kind]["loss"], noise, lr,
                             cs.STEP_UPDATE_RTOL)
        res[kind] = {**held, "dp_step_ms": got[kind]["step_ms"][0],
                     "dp_step_ms_spread": got[kind]["step_ms"][1],
                     "single_step_ms": cs._period_ms(
                         lambda: step(state, x, y))[0]}
    return res


def frontend_checks(n: int) -> dict:
    """Section 1: one shard per GPU against one unsharded launch."""
    from sm_hpss_mtl_tpu_torch.ops import frontend
    from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank
    from sm_hpss_mtl_tpu_torch.parallel import (make_mesh,
                                                stft_hpss_mel_time_sharded)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 40)
    y = torch.randn((2, 400 + (cs.SHARD_FRAMES - 1) * 160), generator=gen,
                    device="cuda")
    M = mel_filterbank(22050, 400, 120, device="cuda")
    mesh = make_mesh(n_data=1, n_time=n)
    kw = dict(n_fft=400, win_length=400, hop_length=160, l_harm=21,
              l_perc=11)
    ht, Tl = 21 // 2, cs.SHARD_FRAMES // n
    out = {}
    for name, basis in (("mel", M), ("fullres", None)):
        with cs.recorded() as rec:
            got = stft_hpss_mel_time_sharded(y, basis, mesh)
        cs.check(rec["halo"][("K1" if basis is not None else "K2")] == n,
                 f"{name}: halo-mode launches {dict(rec['halo'])}")
        want = frontend.launch(y, basis, **kw)
        err = cs.compare(f"{name} over {n} GPUs", got, want, cs.RTOL,
                         cs.ATOL)
        out[name] = {"max_abs_delta": err, "per_join_max_abs_delta": [
            max(float((a - b)[..., j * Tl - ht:j * Tl + ht].abs().max())
                for a, b in zip(got, want)) for j in range(1, n)],
            "devices": sorted({str(d) for d in mesh.along("time")})}
    return out


def segment_checks(n: int, tmp: str) -> dict:
    """Section 2: the segmenter's featurizer over the N GPUs against one."""
    from sm_hpss_mtl_tpu_torch.cli import segment as cli
    _, x = cs.write_broadcast(tmp, "b600.wav", 600.0, cs.SEED + 1)
    preset = cli.MODEL_PRESETS[MODEL]
    dev = torch.device("cuda", 0)
    devices = [torch.device("cuda", i) for i in range(n)]
    with cs.recorded() as rec:
        sharded = cli._featurize_broadcast(x, preset, dev, devices)
    cs.check(rec["halo"]["K1"] == n, f"segmenter halo-mode launches "
                                     f"{dict(rec['halo'])}")
    single = cli._featurize_broadcast(x, preset, dev, [dev])
    db = float((sharded - single).abs().max())
    cs.check(sharded.shape == single.shape and db <= cs.FEATURE_DB_TOL,
             f"segmenter over {n} GPUs vs one: {db:.4f} dB")
    return {"frames": int(sharded.shape[-1]), "max_abs_db": db,
            "featurize_sharded_ms": cs._host_ms(
                lambda: cli._featurize_broadcast(x, preset, dev, devices)),
            "featurize_one_gpu_ms": cs._host_ms(
                lambda: cli._featurize_broadcast(x, preset, dev, [dev]))}


def trial_checks(n: int) -> dict:
    """Section 3: 2N trials over the N GPUs against unsharded on GPU 0."""
    from sm_hpss_mtl_tpu_torch.parallel import make_mesh
    from sm_hpss_mtl_tpu_torch.train.multitrial import (fit_multi,
                                                        init_trials,
                                                        unstack_trial)
    from sm_hpss_mtl_tpu_torch.train.optimizers import for_model
    data = _batch()
    net = cs._seeded(MODEL)
    trials = [{**t, "seed": cs.SEED + i} for i, t in
              enumerate((cs._multi_trials() * n)[:2 * n])]
    x = data["patches"].cuda()
    y = {k: v.cuda() for k, v in data["labels"].items()}

    def stream():
        while True:
            yield x, y

    def make_opt(ps):
        return for_model(MODEL, ps, 100000, trial_axis=True)[0]

    kw = dict(mtl=True, trials=trials, heads=("3C", "M", "R", "S"),
              epochs=1, steps_per_epoch=4, val_steps=1, l2_reg=0.01,
              verbose=False)
    t0 = time.perf_counter()
    sharded = fit_multi(net, make_opt, stream(), stream(),
                        mesh=make_mesh(), **kw)
    torch.cuda.synchronize()
    t_sharded = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = fit_multi(net, make_opt, stream(), stream(), device="cuda",
                      **kw)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    cs.check(sorted({str(next(iter(st.params.values())).device)
                     for st in sharded.shards})
             == sorted(f"cuda:{i}" for i in range(n)),
             "the trials did not go to every GPU")
    noise = cs._bn_fed_biases(net)
    held = []
    for i, t in enumerate(trials):
        before = unstack_trial(init_trials(net, [t["seed"]], make_opt,
                                           "cpu"), 0)
        held.append(cs._hold_step(
            f"trial {i} over {n} GPUs", before, unstack_trial(plain.state, i),
            unstack_trial(sharded.state, i), float(plain.best_val_loss[i]),
            float(sharded.best_val_loss[i]), noise, 0.002 * t["lr_scale"],
            cs.STEP_UPDATE_RTOL))
    return {"trials": len(trials),
            "update_rel_max": max(h["update_rel_max"] for h in held),
            "loss_rel_max": max(h["loss_rel"] for h in held),
            "sharded_s": t_sharded, "unsharded_s": t_plain}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=None,
                   help="also write the JSON result to this file")
    p.add_argument("--worker", nargs=5, default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        rank, world, rdv, inp, out = args.worker
        worker(int(rank), int(world), rdv, inp, out)
        return 0
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print("multi_gpu_check: needs at least two GPUs", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    build_s, _ = cs.build_all()
    res = {"card": card, "gpus": n, "build_s": build_s}
    with tempfile.TemporaryDirectory() as tmp:
        res["frontend"] = frontend_checks(n)
        print(f"frontend ok: {res['frontend']}", flush=True)
        res["segment"] = segment_checks(n, tmp)
        print(f"segment ok: {res['segment']}", flush=True)
        res["trials"] = trial_checks(n)
        print(f"trials ok: {res['trials']}", flush=True)
        res["dp"] = dp_checks(n, tmp)
    res["total_s"] = time.perf_counter() - t0
    line = json.dumps({"multi_gpu": res})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
