from .place import resolve_device, seed
from .resilience import Deadline, bump_counter, counters, reset_counters

__all__ = ["Deadline", "bump_counter", "counters", "reset_counters",
           "resolve_device", "seed"]
