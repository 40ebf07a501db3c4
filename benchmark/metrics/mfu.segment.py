"""Forward FLOPs of every window served and the front end's operations, over the window's wall time at the float32 peak."""

from benchmark.readers import segment_mfu as read  # noqa: F401
