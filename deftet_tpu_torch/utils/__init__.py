"""Host utilities: OBJ IO and the span recorder."""

from .objio import load_obj, save_obj
from .timing import Timer, TimingRegistry

__all__ = ["Timer", "TimingRegistry", "load_obj", "save_obj"]
