"""Utilities: benchmarking, results and configuration writers, profiling
(counterpart of ``sm_hpss_mtl_tpu/utils``)."""

from .benchmarking import time_op  # noqa: F401
from .profiling import device_trace, stage_timer  # noqa: F401
from .results import append_results, dump_configuration, dump_model_summary  # noqa: F401
