from .adamw import AdamW, AdamWState, adamw_init, adamw_update, global_norm
from .grad_compress import dequantize, init_ef, neurlz_grad_archive, quantize_ef
from .schedule import cosine_schedule, warmup_cosine

__all__ = ["AdamW", "AdamWState", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "warmup_cosine", "quantize_ef", "dequantize",
           "init_ef", "neurlz_grad_archive"]
