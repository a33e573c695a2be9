"""Utilities: logging, profiling, observability."""

from .logging import StreamToLogger, get_logger, setup_logging
from .profiling import (StepTimer, device_memory_stats, find_max_batch_size,
                        trace)
from .visualize import (list_layers, visualize_layer_parameters,
                        visualize_weight_overview)

__all__ = ["StreamToLogger", "get_logger", "setup_logging",
           "StepTimer", "device_memory_stats", "find_max_batch_size",
           "trace",
           "list_layers", "visualize_layer_parameters",
           "visualize_weight_overview"]
