from .logging import get_logger, init_logger
from .memory import check_memory_usage, device_memory_stats, host_rss_mb

__all__ = ["get_logger", "init_logger", "check_memory_usage",
           "device_memory_stats", "host_rss_mb"]
