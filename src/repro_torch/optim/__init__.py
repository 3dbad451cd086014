from .adamw import AdamW
from .schedule import cosine_schedule

__all__ = ["AdamW", "cosine_schedule"]
