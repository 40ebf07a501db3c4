"""Whisper-MTL at the published widths on the card (``card``: skipped
without a GPU; on the card ``python -m pytest --noconftest
tests/test_torch_whisper_card.py -m card -s``, as ``tests/conftest.py``
imports JAX, which the GPU machine lacks).  This file imports no JAX."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.reference import layers as rlayers
from benchmark.reference import precision
from benchmark.reference.models import whisper_mtl as rwhisper
from sm_hpss_mtl_tpu_torch.models.zoo import get_model

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def test_one_context_matches_the_reference_within_the_cells_limit(card):
    cell = harness.load_cell("whisper_mtl.segment_seq")
    cfg = cell.config
    with torch.device(card):
        net = get_model(cfg["model"])
    W = harness.seeded_weights(net, 2 ** 31 + 5, card, cfg)
    net.load_state_dict(W)
    net = net.to(card).eval()
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(2, 256, 3000, generator=g, device=card)
    with torch.inference_mode():
        got = net(x)
    Wd = {k: v.to(card) for k, v in W.items() if v.is_floating_point()}
    with torch.no_grad(), precision.products():
        want = rwhisper.forward(x, Wd, cfg, rlayers.Draws(None), train=False)
    limit = cell.limits["track_gap"]["limit"]
    gaps = {h: float((got[h] - want[h]).abs().max()) for h in want}
    print({"whisper_card_gaps": gaps, "limit": limit})
    assert got["S"].shape == (2, 1500, 1)
    assert max(gaps.values()) <= limit, gaps
