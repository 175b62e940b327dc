"""Native (C++) runtime parts of the port, bound with ctypes: the
prefetching batch loader (``dataloader.cpp``, ``loader.py``)."""
from .loader import NativeDataloader

__all__ = ["NativeDataloader"]
