"""Small utilities: timing, profiling, field I/O, failure recovery."""

from randomfield_tpu_torch.utils.timing import Timer, block_and_time

__all__ = ["Timer", "block_and_time"]
