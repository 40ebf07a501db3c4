"""One module per kind of traffic mix, named by a mix's ``kind``: each
has ``run(cell, seed, seconds, traced, device, card) -> harness.Run``."""
