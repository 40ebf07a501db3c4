"""How far the PyTorch port's ``cli.segment`` tracks sit from the JAX CLI's.

    JAX_PLATFORMS=cpu python tools/port_track_gap.py

Runs both CLIs on the CPU on the same 1.4 s synthetic broadcast with the
same full-width Lemaire-MTL weights (a seeded JAX init, saved as an orbax
checkpoint for the JAX CLI and as ``.npz`` for the port), as
``tests/test_torch_segment.py::test_cli_segment_matches_jax_cli`` does.
The JAX CLI runs twice: unmodified, and with its ``standardize_rows``
centring constant feature rows to 0 as the port and sklearn do.  Prints
one JSON object: per track, the max |port - JAX| of each run, and the
smoothed labels that differ.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _broadcast(seconds: float, seed: int) -> np.ndarray:
    """Tones, clicks and a speech-like burst, as 16 kHz float32 (the
    test's broadcast)."""
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * (t < seconds / 2)
    burst = np.sin(2 * np.pi * 140 * t) * (np.sin(2 * np.pi * 4 * t) > 0)
    x = x + 0.3 * burst * (t >= seconds / 2) + 0.02 * rng.standard_normal(n)
    for k in range(0, n - 40, 3200):
        x[k:k + 40] += 0.8 * np.hanning(40)
    return x.astype(np.float32)


def main() -> dict:
    import jax
    import jax.numpy as jnp
    import torch
    from scipy.io import wavfile

    from sm_hpss_mtl_tpu.cli import segment as jcli
    from sm_hpss_mtl_tpu.eval import segment as jseg
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.ops.patches import standardize_rows
    from sm_hpss_mtl_tpu.train import TrainState, for_model
    from sm_hpss_mtl_tpu.train.checkpoint import save_checkpoint
    from sm_hpss_mtl_tpu_torch import weights
    from sm_hpss_mtl_tpu_torch.cli import segment as tcli

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "b.wav")
        wavfile.write(wav, 16000,
                      (_broadcast(1.4, 1) * 32767).astype(np.int16))
        spec = get_model("Lemaire_et_al_MTL", n_mels=120)
        opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=1)
        state = TrainState.create(spec.module, opt, jnp.zeros((2, 68, 240)),
                                  jax.random.PRNGKey(4))
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, state)
        npz = os.path.join(tmp, "w.npz")
        weights.save_npz(npz, jax.tree_util.tree_map(
            np.asarray, {"params": state.params,
                         "batch_stats": state.batch_stats}))

        common = [wav, "--head", "M", "--chunk-frames", "32",
                  "--smooth-win", "11"]

        def tracks(out):
            with np.load(out) as z:
                return {k: z[k] for k in z.files}

        _, tlab = tcli.main(common + ["--weights", npz, "--device", "cpu",
                                      "--out", os.path.join(tmp, "t.npz")])
        port = tracks(os.path.join(tmp, "t.npz"))
        _, jlab = jcli.main(common + ["--ckpt", ckpt,
                                      "--out", os.path.join(tmp, "j.npz")])
        unmodified = tracks(os.path.join(tmp, "j.npz"))

        def centred(FV):
            FV = np.asarray(FV)
            out = np.array(standardize_rows(FV))
            out[FV.max(axis=-1) == FV.min(axis=-1)] = 0.0
            return out

        orig = jseg.standardize_rows
        jseg.standardize_rows = centred
        try:
            _, clab = jcli.main(common + ["--ckpt", ckpt,
                                          "--out", os.path.join(tmp, "c.npz")])
        finally:
            jseg.standardize_rows = orig
        fixed = tracks(os.path.join(tmp, "c.npz"))

    def gap(ref):
        return {k: float(np.abs(port[k] - ref[k]).max()) for k in sorted(port)}

    return {"frames": int(port["track_M"].shape[0] + 67),
            "jax_unmodified": {"max_abs": gap(unmodified),
                               "labels_differ": int((tlab != jlab).sum())},
            "jax_constant_rows_centred": {
                "max_abs": gap(fixed),
                "labels_differ": int((tlab != clab).sum())}}


if __name__ == "__main__":
    print(json.dumps(main()))
