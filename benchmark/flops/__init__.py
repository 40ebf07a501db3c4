"""Analytic forward FLOPs per window of each model family, one module per
family (``<family>.py`` with ``forward_flops(cfg)``): two per
multiply-accumulate of every convolution and dense layer, as
``torch.utils.flop_counter`` counts them."""
