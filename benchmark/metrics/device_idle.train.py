"""The share of the traced window in which no operation ran on the device."""

from benchmark.readers import idle_share as read  # noqa: F401
