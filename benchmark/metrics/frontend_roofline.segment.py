"""The front end's least time over the traced requests' frames, over the device time launched inside the spans around _featurize_broadcast."""

from benchmark.readers import segment_frontend_roofline as read  # noqa: F401
