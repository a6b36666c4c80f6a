"""Memory probes (port of ``thunder_tpu.utils.memory``): the host's RSS
(memoryCheckRM, include/Utils.h:23) and the CUDA allocator's view of the
device, logged to the MEM logger (CHECK_MEMORY_USAGE,
include/Parallel.h:106-112)."""

import torch

from .logging import get_logger


def host_rss_mb():
    """Resident set size of this process in MB (VmRSS of
    /proc/self/status), NaN where that file is missing."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return float("nan")


def device_memory_stats(device=None):
    """The CUDA allocator's bytes in use and their peak under the JAX
    package's keys (``bytes_in_use``, ``peak_bytes_in_use``); {} for a
    CPU device or without CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    st = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": st.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": st.get("allocated_bytes.all.peak", 0)}


def check_memory_usage(tag="", device=None):
    """Log host RSS (and the device's bytes in use when there are any) to
    the MEM logger; returns the device stats."""
    stats = device_memory_stats(device)
    extra = ""
    if "bytes_in_use" in stats:
        extra = f", device {stats['bytes_in_use'] / 1e6:.0f} MB in use"
        extra += f" (peak {stats['peak_bytes_in_use'] / 1e6:.0f} MB)"
    get_logger("MEM").info("%sRSS %.0f MB%s", f"{tag}: " if tag else "",
                           host_rss_mb(), extra)
    return stats
