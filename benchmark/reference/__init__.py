"""Plain PyTorch reference of what the benchmark's cells run: the HPSS
front end, Lemaire-MTL and Jang-MTL with their heads, the losses, the two
optimizers, one training step and the streaming segmenter.

Written from the original system's definitions (librosa's STFT, median
HPSS and mel bank, the keras-tcn block, the Keras layers, losses and
optimizers), not from the port: it imports nothing of
``sm_hpss_mtl_tpu_torch``, ``sm_hpss_mtl_tpu`` or ``jax``.  It takes the
weights and audio the benchmark made, or the inputs the program was
handed, and recomputes everything derived from them.
"""
