"""Utilities: profiling, device/topology info, roofline accounting."""

from .profiling import Roofline, device_info, trace

__all__ = ["trace", "device_info", "Roofline"]
