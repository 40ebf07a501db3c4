"""The bf16 bars of ``chip_smoke.py`` (``bf16_step_checks``), on the CPU.

The card's bf16 steps are held per parameter to twice the CPU's spread
that ``tools/bf16_step_bars.py`` recorded in ``tools/bf16_step_bars.json``.
Here: the file records a spread for every parameter that the check holds
(a model change that adds or renames one must rerun the tool), and the
bars refuse a step that updates nothing or half, and pass the step
itself.  Made-up state dicts, no model is run.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from sm_hpss_mtl_tpu_torch.models.zoo import get_model

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("model", ["Lemaire_et_al_MTL", "Jang_et_al_MTL"])
def test_bars_file_covers_every_held_parameter(cs, model):
    assert set(cs.BF16_STEP_MODELS) == set(cs.bf16_step_bars())
    net = get_model(model)
    held = {k for k, _ in net.named_parameters()} - cs._bn_fed_biases(net)
    spread = cs.bf16_step_bars()[model]
    assert set(spread["update_rel"]) == held
    assert all(0 < v < 1 for v in spread["update_rel"].values())
    assert 0 < spread["loss_rel"] < 1e-2 and 0 < spread["stats_err_max"]


def _states(seed=0):
    """A state before a step, the step's state after it, and a
    BatchNorm-fed bias; the step's loss and lr."""
    g = torch.Generator().manual_seed(seed)
    before = {"a.weight": torch.randn(4, 8, generator=g),
              "a.bias": torch.randn(4, generator=g),
              "out.bias": torch.randn(1, generator=g),
              "bn.running_mean": torch.zeros(4),
              "bn.running_var": torch.ones(4),
              "bn.num_batches_tracked": torch.tensor(0)}
    after = {k: v + 1e-3 * torch.randn(v.shape, generator=g)
             if v.is_floating_point() else v + 1 for k, v in before.items()}
    # The BatchNorm-fed bias moves by rounding noise only.
    after["a.bias"] = before["a.bias"] + 1e-9 * torch.randn(4, generator=g)
    return before, (2.0, after, 1e-3), {"a.bias"}


@pytest.mark.parametrize("scale, refused", [(1.0, False), (0.5, True),
                                            (0.0, True)])
def test_bars_refuse_a_degenerate_update(cs, scale, refused):
    before, step, noise = _states()
    spread = {"loss_rel": 1e-4, "stats_err_max": 1e-4,
              "bn_fed_bias_update_max_per_lr": 1e-3,
              "update_rel": {"a.weight": 0.6, "out.bias": 0.6}}
    r, upd = cs._spread(before, cs._scaled(before, step, scale), step, noise)
    bad, share = cs._bf16_violations(r, upd, spread, nondegenerate=True)
    assert bool(bad) == refused, bad
    # A spread of 0.6 gives a bar of 1.2 of the update's norm (plus a
    # rounding floor), which a halved or zeroed update passes: only the
    # norm ratio and the cosine refuse them.
    assert share == pytest.approx((1 - scale) / 1.2, rel=1e-3, abs=1e-12)


def test_kernel_bounds_are_the_benchmarks(cs):
    """``chip_smoke.py`` prices K1, K3 and K4 by ``benchmark/counts.py``
    (in ms), at the shapes of ``PERF.md``'s kernel table: K1 at 1 x 16404
    frames, K3 at 1 x 201 x 5998, K4 at T = 13 and 5998, (21, 11), with the
    shared-core comparators and the 120-band bank's nonzeros."""
    from benchmark import counts
    from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank
    card = "NVIDIA H100 80GB HBM3"
    cmp = cs.median_comparators()[1][(21, 11)]
    nnz = int((mel_filterbank(22050, 400, 120) != 0).sum())
    N = 400 + 16403 * 160
    k1, by, _ = cs.frontend_bound_ms(16404, N, 400, cmp, card, n_mels=120,
                                     mel_nnz=nnz)
    assert k1 == 1e3 * counts.frontend_bound_s(16404, N, 400, cmp, card,
                                               n_mels=120, mel_nnz=nnz)
    assert by == "bytes"
    k3 = cs.k3_bound_ms(1, 201, 5998, cmp, card)
    assert k3 == 1e3 * counts.k3_bound_s(1, 201, 5998, cmp, card)
    k4 = {T: cs.k4_bound_ms(1, 201, T, 120, nnz, cmp, card)
          for T in (13, 5998)}
    for T, ms in k4.items():
        assert ms == 1e3 * counts.k4_bound_s(1, 201, T, 120, nnz, cmp, card)
    assert [float(f"{v:.4g}") for v in (k1, k3, k4[13], k4[5998])] == [
        0.007864, 0.004319, 3.565e-5, 0.003187]
