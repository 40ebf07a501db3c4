"""Model FLOPs of the training steps (3 x forward per patch) and the front end's operations, over the window's wall time at the float32 peak."""

from benchmark.readers import train_mfu as read  # noqa: F401
