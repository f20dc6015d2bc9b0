"""Benchmarking, calibration, and instrumentation harness.

Rebuild of the reference's L3 perf harness (``cpp_impl/perf.cpp``,
``cpp_impl/main.cpp:251-296``) and instrumentation layer
(``-DINSTRUMENTATION_RUN``); see SURVEY.md §5 tier mapping.
"""

from ternary_spgemm_tpu.bench.harness import (
    BenchConfig,
    KernelResult,
    dump_json,
    run_config,
    to_reference_json,
)
from ternary_spgemm_tpu.bench.instrument import (
    Instrumentation,
    advertised_hbm_bandwidth,
    instrument,
    measure_hbm_bandwidth,
    roofline_fraction,
)
from ternary_spgemm_tpu.bench.stacked import measure_stacked_marginal
from ternary_spgemm_tpu.bench.timing import TIMERS, TimingResult, time_device_loop, time_wall

__all__ = [
    "BenchConfig", "KernelResult", "run_config", "to_reference_json", "dump_json",
    "Instrumentation", "instrument", "advertised_hbm_bandwidth",
    "measure_hbm_bandwidth", "roofline_fraction", "measure_stacked_marginal",
    "TIMERS", "TimingResult", "time_device_loop", "time_wall",
]
