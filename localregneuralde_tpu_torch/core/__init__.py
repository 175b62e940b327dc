from .containers import ArrayAndTime, get_array

__all__ = ["ArrayAndTime", "get_array"]
