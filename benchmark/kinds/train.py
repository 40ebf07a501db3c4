"""Training through the device pipeline, as ``cli/experiment.py::run_fold``
builds it for a fold: the fold's crop stream (``AudioCropBatcher`` over an
in-memory ``AudioCache``, behind a ``DevicePrefetcher``), and the audio
train step of ``_device_pipeline`` (K1 or K2, the patches, the model, the
losses, the backward pass and the optimizer's update), driven as
``train/loop.py::fit`` drives it: ``next`` of the stream, the step, the
metrics summed on the device.

Set-up builds the one step object, runs its first ``check_steps`` steps
through that loop, then ``warmup_steps`` more, which also bring every item
of the corpus into the cache.  The window runs steps until ``--seconds``
have passed and at least ``check_steps`` have run, then fetches the
metrics once.  A traced run profiles the window's last ``trace_seconds``.

The check follows two runs of ``check_steps`` steps with the reference,
each on the batches and generator state the program's steps had:

- the first steps of set-up, from the weights the benchmark made and a
  fresh optimizer (the numbers ``loss_gap``, ``first_loss_gap``,
  ``grad_gap``, ``change_gap``);
- the window's first steps, from the program's own state as the window
  found it: its weights, buffers and optimizer state, copied before the
  window opens (the same numbers, named ``window_*``).  The window keeps
  each step's batch, copies the optimizer's first moments after its
  first step and the parameters after its last into buffers made in
  set-up: two device copies and no synchronise.

Compared: each step's loss (the worst step's gap, the median step's, or
the first step's; the limits name which); each parameter's gradient as the optimizer
took it at the first step, worked out from its first moment before and
after (the configuration's ``optimizer.program_state`` names where the
program keeps it; the reference's ``optimizers/<kind>.py`` inverts the
update); and each parameter's change over the steps, both by the gap
between the program's norm and the reference's, over the reference's norm
of that leaf or of the median leaf, whichever is larger.  Leaves whose
reference gradient is under a thousandth of the median leaf's (a bias
that feeds a BatchNorm) move by round-off alone and are left out of the
change.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time

import numpy as np
import torch

from .. import harness
from ..reference import frontend as ref_frontend
from ..reference import optimizers as ref_optimizers
from ..reference import train as ref_train
from ..trace import Profiler
from ..traffic import generate

#: A leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of the change (round-off is all that moves it).
ROUNDOFF_LEAF = 1e-3


def _relative_gaps(prog: dict, ref: dict) -> float:
    """Worst leaf's ``| |p| - |r| | / max(|r|, median |r|)``."""
    rn = {k: float(v.double().norm()) for k, v in ref.items()}
    med = float(np.median(list(rn.values())))
    return max(abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
               for k in rn)


def on_host(out: dict) -> dict:
    """A reference run's result with its tensors on the host."""
    return {"loss": out["loss"],
            "first_grad": {k: v.cpu() for k, v in out["first_grad"].items()},
            "params": {k: v.cpu() for k, v in out["params"].items()}}


def readings(prog: dict, ref: dict, w0: dict, prefix: str = "") -> dict:
    """The compared numbers of a check (see the module doc)."""
    prog, ref = on_host(prog), on_host(ref)
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    g_ref = ref["first_grad"]
    norms = {k: float(v.double().norm()) for k, v in g_ref.items()}
    med = float(np.median(list(norms.values())))
    moved = {k for k, n in norms.items() if n >= ROUNDOFF_LEAF * med}
    d_ref = {k: ref["params"][k] - w0[k] for k in moved}
    d_prog = {k: prog["params"][k] - w0[k] for k in moved}
    first = abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
    out = {"loss_gap": max(gaps), "median_loss_gap": float(np.median(gaps)),
           "first_loss_gap": first,
           "grad_gap": _relative_gaps(prog["first_grad"], g_ref),
           "change_gap": _relative_gaps(d_prog, d_ref)}
    return {prefix + k: v for k, v in out.items()}


class TrainCell:
    """The program's training step for one cell, from the seed."""

    def __init__(self, cell: harness.Cell, seed: int, device, root: str):
        from sm_hpss_mtl_tpu_torch.cli.experiment import (
            _device_pipeline, _label_map, class_names_for, split_train_val)
        from sm_hpss_mtl_tpu_torch.data.folds import (create_cv_folds,
                                                      get_train_test_files)
        from sm_hpss_mtl_tpu_torch.models.zoo import get_spec
        from sm_hpss_mtl_tpu_torch.parallel.distributed import \
            per_process_seed
        from sm_hpss_mtl_tpu_torch.train.config import ExperimentConfig
        from sm_hpss_mtl_tpu_torch.train.optimizers import for_model
        from sm_hpss_mtl_tpu_torch.train.state import TrainState
        cfg, mix = cell.config, cell.mix
        self.cfg, self.mix, self.device = cfg, mix, device
        self.phases = harness.Phases()
        data = generate.make_corpus(os.path.join(root, "corpus"), seed,
                                    cfg["train_corpus"])
        self.phases.mark("corpus")
        cv = create_cv_folds(data, cv=mix["cv_folds"], seed=seed)
        files, _ = get_train_test_files(cv, mix["fold"],
                                        class_names=class_names_for(3))
        tr, _ = split_train_val(files, seed=seed)
        # The window runs training steps only: the validation stream gets
        # an empty split, so that set-up does not load the fold's
        # validation files for it.
        va = {cls: [] for cls in tr}
        config = ExperimentConfig(
            model=cfg["model"], data_root=data, feature_dir="",
            output_dir="", cv_folds=mix["cv_folds"],
            batch_size=mix["batch_size"], patch_size=mix["patch_size"],
            patch_shift=mix["patch_shift"], clip_patches=mix["clip_patches"],
            augment_noise=mix["augment_noise"], l2_reg=cfg["l2_reg"],
            dft_precision=cfg["features"]["dft_precision"], seed=seed,
            tr_steps=cfg["optimizer"].get("decay_tr_steps", 1))
        feat_cfg = config.feature_config()
        program = cfg["program"]
        mels = ({"n_mels": program["n_mels"]} if "n_mels" in program
                else {})
        with torch.device(device):
            spec = get_spec(config.model, n_classes=config.n_classes,
                            patch_size=config.patch_size, in_dim=feat_cfg.dim,
                            dropout_rate=config.dropout_rate, **mels,
                            **program["arch_kwargs"])
        self.net = spec.module.to(device)
        self.weights = harness.seeded_weights(self.net, seed, device, cfg)
        self.net.load_state_dict(self.weights)
        self.phases.mark("model")
        self.optimizer, _ = for_model(config.model, self.net.parameters(),
                                      tr_steps=max(config.tr_steps, 1))
        self.generator = torch.Generator(device=device).manual_seed(seed)
        train_iter, val_iter, self.train_step, _ = _device_pipeline(
            config, spec, feat_cfg, tr, va, per_process_seed(seed),
            self.optimizer, device, self.generator, None, config.l2_reg)
        val_iter.close()
        self.train_iter = train_iter
        self.stream = _label_map(train_iter, spec.mtl)
        self.state = TrainState(self.net, self.optimizer)
        self.acc = None
        self.phases.mark("pipeline")

    def moments(self) -> tuple[dict, dict, int]:
        """The optimizer's first and second moments per parameter name, as
        its state holds them (None where it holds none), and the updates
        it has taken."""
        keys = self.cfg["optimizer"]["program_state"]
        m, v, t = {}, {}, 0
        for name, p in self.net.named_parameters():
            st = self.optimizer.state.get(p, {})
            m[name] = st.get(keys["m"])
            v[name] = st.get(keys["v"]) if keys.get("v") else None
            if keys["step"] in st:
                t = int(st[keys["step"]])
        return m, v, t

    def step(self, spans=None):
        from sm_hpss_mtl_tpu_torch.train.loop import _accumulate
        if spans is None:
            batch, labels = next(self.stream)
            metrics = self.train_step(self.state, batch, labels)
        else:
            with spans("input_wait"):
                batch, labels = next(self.stream)
            with spans("step"):
                metrics = self.train_step(self.state, batch, labels)
        self.acc = _accumulate(self.acc, metrics)
        return batch, labels, metrics

    def finish(self) -> None:
        """Fetch the summed metrics once (the loop's per-epoch fetch)."""
        from sm_hpss_mtl_tpu_torch.train.loop import _fetch_mean
        _fetch_mean(self.acc, 1)
        harness.sync(self.device)

    def close(self) -> None:
        self.train_iter.close()
        for name in ("net", "optimizer", "train_step", "state", "stream",
                     "train_iter", "acc"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def batch_faults(batches: list, tag: str) -> list[str]:
    """The checked steps' inputs: finite, each row a distinct crop."""
    out = []
    for k, (audio, _) in enumerate(batches):
        if not torch.isfinite(audio).all():
            out.append(f"{tag} step {k}: audio not finite")
        if torch.unique(audio, dim=0).shape[0] != audio.shape[0]:
            out.append(f"{tag} step {k}: two rows of the batch are the "
                       "same crop")
    return out


def patches_per_step(cfg: dict, mix: dict, audio: torch.Tensor) -> int:
    f = cfg["features"]
    T = ref_frontend.n_frames(audio.shape[-1], f["n_fft"], f["hop_length"])
    k = len(ref_frontend.patch_starts(T, mix["patch_size"],
                                      mix["patch_shift"])
            [:mix["clip_patches"]])
    return audio.shape[0] * k


class Steps:
    """``n`` steps of the program as the reference follows them: the
    weights, optimizer state and generator state before them, the batches
    they were handed, their losses, the first moments after the first and
    the parameters after the last.  ``fresh``: the steps are the program's
    first, from the benchmark's weights and an optimizer with no state;
    otherwise the state before them is copied to the host now."""

    def __init__(self, prog: "TrainCell", n: int, fresh: bool):
        self.n, self.opt = n, prog.cfg["optimizer"]
        self.gen_state = prog.generator.get_state()
        self.params = dict(prog.net.named_parameters())
        m, v, self.t0 = prog.moments()
        if fresh:
            self.weights, self.start = prog.weights, None
            self.m0 = None
        else:
            def host(d):
                return {k: (None if x is None
                            else x.detach().to("cpu", copy=True))
                        for k, x in d.items()}
            self.weights = host(prog.net.state_dict())
            self.m0 = host(m)
            self.start = {"t": self.t0, "m": self.m0, "v": host(v)}
        self._m1 = [torch.empty_like(p) for p in self.params.values()]
        self._p = [torch.empty_like(p) for p in self.params.values()]
        self.batches, self._losses = [], []

    @property
    def done(self) -> bool:
        return len(self.batches) >= self.n

    def after(self, prog: "TrainCell", batch, labels, metrics) -> None:
        """Keep what the step just taken was handed and left: device
        references and copies only."""
        k = len(self.batches)
        self.batches.append((batch, labels))
        self._losses.append(metrics["loss"])
        if k == 0:
            m = prog.moments()[0]
            torch._foreach_copy_(self._m1, [
                m[name] if m[name] is not None else torch.zeros_like(p)
                for name, p in self.params.items()])
        if k == self.n - 1:
            torch._foreach_copy_(self._p, [p.detach() for p in
                                           self.params.values()])

    def result(self) -> dict:
        """On the host: the program's side of the check, and the steps'
        batches for the reference (call once the steps have run)."""
        def host(x):
            return x.detach().to("cpu", copy=True)
        self.batches = [(host(a), {h: host(y) for h, y in lab.items()})
                        for a, lab in self.batches]
        kind = ref_optimizers.kind(self.opt)
        first = {}
        for (name, p), m1 in zip(self.params.items(), self._m1):
            m0 = (self.m0 or {}).get(name)
            m0 = torch.zeros_like(p, device="cpu") if m0 is None else m0
            first[name] = kind.gradient(self.opt, m0.double(),
                                        host(m1).double(), self.t0).float()
        out = {"loss": [float(x) for x in self._losses],
               "first_grad": first,
               "params": {name: host(p) for name, p in
                          zip(self.params, self._p)}}
        self.params = dict.fromkeys(self.params)
        self._m1 = self._p = self._losses = None
        return out

    def follow(self, cfg: dict, mix: dict, device, **kw) -> dict:
        """The reference over the same steps (``kw``: ``keep``, ``tf32``)."""
        return ref_train.run_steps(self.weights, self.batches,
                                   self.gen_state, cfg, mix, device,
                                   start=self.start, **kw)

    def w0(self) -> dict:
        """The parameters before the steps, on the host."""
        return {k: self.weights[k] for k in self.params}


def controls(checks: dict, cell: harness.Cell, device) -> dict:
    """The readings of the control (the reference with TF32 products in
    the program's place) and of a step that leaves half of each batch
    out, each against the reference, for each check (``checks``: prefix
    -> (steps, reference result)).  Not part of a benchmark run."""
    out = {"tf32": {}, "half_batch": {}}
    for prefix, (steps, ref) in checks.items():
        rows = patches_per_step(cell.config, cell.mix, steps.batches[0][0])
        low = steps.follow(cell.config, cell.mix, device, tf32=True)
        half = steps.follow(cell.config, cell.mix, device,
                            keep=slice(0, rows // 2))
        out["tf32"].update(readings(low, ref, steps.w0(), prefix))
        out["half_batch"].update(readings(half, ref, steps.w0(), prefix))
    return out


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, card: dict,
        with_controls: bool = False) -> harness.Run:
    mix, n = cell.mix, cell.mix["check_steps"]
    run = harness.Run(cell=cell, card=card,
                      spans=harness.Spans(traced))
    with tempfile.TemporaryDirectory(prefix="bench-train-") as root:
        prog = TrainCell(cell, seed, device, root)
        run.setup = prog.phases
        first = Steps(prog, n, fresh=True)
        while not first.done:
            first.after(prog, *prog.step())
        checked = {"": (first, first.result())}
        run.setup.mark("check_steps")
        for _ in range(mix["warmup_steps"]):
            prog.step()
        window = Steps(prog, n, fresh=False)
        profiler = Profiler() if traced else None
        if profiler is not None:
            profiler.prime()
        run.setup.mark("warmup")
        trace_from = max(0.0, seconds - mix["trace_seconds"])
        harness.sync(device)
        run.window_start = time.time()
        t0 = time.perf_counter()
        steps = traced_steps = 0
        while True:
            if profiler is not None and not profiler.active \
                    and time.perf_counter() - t0 >= trace_from:
                profiler.start()
            out = prog.step(run.spans)
            if not window.done:
                window.after(prog, *out)
            steps += 1
            if profiler is not None and profiler.active:
                traced_steps += 1
            if time.perf_counter() - t0 >= seconds and window.done:
                break
        prog.finish()
        run.window_s = time.perf_counter() - t0
        if profiler is not None:
            profiler.stop()
            run.trace = profiler.summary
        run.memory_peak_bytes = harness.memory_peak(device)
        checked["window_"] = (window, window.result())
        prog.close()
    audio = first.batches[0][0]
    per_step = patches_per_step(cell.config, mix, audio)
    run.attempted = steps
    run.e2e["train_patches_per_s"] = steps * per_step / run.window_s
    run.counters.update(steps=steps, traced_steps=traced_steps,
                        patches_per_step=per_step, clips=int(audio.shape[0]),
                        crop_samples=int(audio.shape[1]))
    refs = {}
    for prefix, (steps_, prog_side) in checked.items():
        run.faults += batch_faults(steps_.batches, prefix + "check")
        refs[prefix] = (steps_, steps_.follow(cell.config, mix, device))
        run.readings.update(readings(prog_side, refs[prefix][1],
                                     steps_.w0(), prefix))
    if with_controls:
        run.counters["controls"] = controls(refs, cell, device)
    return run
