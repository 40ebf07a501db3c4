"""Granite-Hybrid-MTL's scan kernel and its model at the published widths
on the card (``card``: skipped without a GPU; on the card ``python -m
pytest --noconftest tests/test_torch_granite_card.py -m card -s``, as
``tests/conftest.py`` imports JAX, which the GPU machine lacks).  This file
imports no JAX."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import layers as rlayers
from benchmark.reference import precision
from benchmark.reference.models import granite_hybrid_mtl as rgranite
from sm_hpss_mtl_tpu_torch.models.zoo import get_model
from sm_hpss_mtl_tpu_torch.ops import ssd_scan
from sm_hpss_mtl_tpu_torch.utils.profiling import counters

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def _inputs(slots: int, L: int, seed: int, card):
    """x, B, C as rows of the mixer's conv output (4352 floats) at 64 heads
    of 64 and states of 128, dt in Mamba-2's range, A in [-16, -1], D and
    a start state."""
    H, P, N = 64, 64, 128
    g = torch.Generator(device=card).manual_seed(seed)
    rows = 0.5 * torch.randn(slots, L, H * P + 2 * N, generator=g,
                             device=card)
    x = rows[..., :H * P].view(slots, L, H, P)
    B, C = rows[..., H * P:H * P + N], rows[..., H * P + N:]
    dt = torch.exp(np.log(1e-3) + np.log(100.0) * torch.rand(
        slots, L, H, generator=g, device=card))
    A = -(1 + 15 * torch.rand(H, generator=g, device=card))
    D = 0.5 + torch.rand(H, generator=g, device=card)
    state = 0.3 * torch.randn(slots, H, P, N, generator=g, device=card)
    return x, dt, A, B, C, D, state


@pytest.mark.parametrize("slots,L,start", [(4, 1500, True), (1, 1500, False),
                                           (2, 256, True), (3, 37, False)])
def test_kernel_matches_the_recurrence(card, slots, L, start):
    x, dt, A, B, C, D, state = _inputs(slots, L, slots * 1000 + L, card)
    state = state if start else None
    before = counters().get("ssd_scan.launches", 0)
    y, s = ssd_scan.ssd_scan(x, dt, A, B, C, D, state)
    torch.cuda.synchronize()
    assert counters()["ssd_scan.launches"] == before + 1
    want_y, want_s = ssd_scan.ssd_scan_plain(
        *(t.double() for t in (x, dt, A, B, C, D)),
        None if state is None else state.double())
    gaps = (float((y.double() - want_y).abs().max() / want_y.abs().max()),
            float((s.double() - want_s).abs().max() / want_s.abs().max()))
    print({"ssd_scan_gaps": gaps, "slots": slots, "L": L, "start": start})
    # The kernel's decays are differences of a float32 cumulative sum over
    # a chunk (down to ~-400): ~3e-5 of the largest output at most.
    assert max(gaps) < 1e-4, gaps


def test_two_chunks_match_one_pass_within_the_cells_limit(card):
    cell = harness.load_cell("granite_hybrid_mtl.segment_stream")
    cfg = cell.config
    with torch.device(card):
        net = get_model(cfg["model"])
    W = harness.seeded_weights(net, 2 ** 31 + 5, card, cfg)
    net.load_state_dict(W)
    net = net.to(card).eval()
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(2, 256, 6000, generator=g, device=card)
    state = net.new_state(2)
    with torch.inference_mode():
        got = [net(x[..., :3000], state), net(x[..., 3000:], state)]
    got = {h: torch.cat([o[h] for o in got], 1) for h in got[0]}
    del net, state
    Wd = {k: v.to(card) for k, v in W.items() if v.is_floating_point()}
    with torch.no_grad(), precision.products():
        want = rgranite.forward(x, Wd, cfg, rlayers.Draws(None), train=False)
    limit = cell.limits["track_gap"]["limit"]
    gaps = {h: float((got[h] - want[h]).abs().max()) for h in want}
    print({"granite_card_gaps": gaps, "limit": limit})
    assert got["S"].shape == (2, 3000, 1)
    assert max(gaps.values()) <= limit, gaps
