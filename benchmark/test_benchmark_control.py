"""The output check's control on the card: for each cell, the reference
computed with TF32 products in the program's place has to come out not
correct, while the program's own run comes out correct, on three seeds
(``control.py`` reads the same numbers at the cells' full size); and the
program itself put in TF32 comes out not correct, since the reference
sets its own precision.  The window is short; the sizes are the cell's
own, so this needs the card."""

from __future__ import annotations

import pytest

from benchmark import harness

CELLS = ("lemaire_mtl.train", "jang_mtl.segment", "lemaire_mtl.segment")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_the_program_passes(name, card):
    cell = harness.load_cell(name)
    kind = harness.load_kind(cell)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        run = kind.run(cell, seed, 2.0, False, card, harness.card(),
                         with_controls=True)
        assert all(c["ok"] for c in harness.compare(run.readings,
                                                    cell.limits)), \
            run.readings
        control = run.counters["controls"]["tf32"]
        assert not all(c["ok"] for c in harness.compare(control,
                                                        cell.limits)), \
            control


@pytest.mark.card
@pytest.mark.parametrize("name", ("jang_mtl.segment", "lemaire_mtl.segment"))
def test_a_program_in_tf32_fails(name, card, monkeypatch):
    """TF32 switched on in the process once the program has built its
    model (which switches it off) puts the model's products in TF32; the
    reference keeps float32 products whatever the process set, so the run
    is not correct.  The segment cells only: the model alone in TF32 moves
    the training cells' numbers less than their sound runs spread (the
    front end, K1/K2, keeps its own precision)."""
    import torch
    cell = harness.load_cell(name)
    kind = harness.load_kind(cell)
    seeded = harness.seeded_weights

    def seeded_then_tf32(*args, **kwargs):
        out = seeded(*args, **kwargs)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return out
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(harness, "seeded_weights", seeded_then_tf32)
    try:
        run = kind.run(cell, 2 ** 31 + 104, 2.0, False, card, harness.card())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    assert not all(c["ok"] for c in harness.compare(run.readings,
                                                    cell.limits)), \
        run.readings
