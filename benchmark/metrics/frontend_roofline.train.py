"""The front end's least time per launch over the device time per launch of its kernels in the trace."""

from benchmark.readers import train_frontend_roofline as read  # noqa: F401
