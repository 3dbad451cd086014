from .adamw import AdamW, AdamWState, adamw_init, adamw_update, global_norm
from .grad_compress import (bf16_psum, compressed_psum, dequantize, init_ef,
                            neurlz_grad_archive, quantize_ef)
from .schedule import cosine_schedule, warmup_cosine

__all__ = ["AdamW", "AdamWState", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "warmup_cosine", "quantize_ef", "dequantize",
           "init_ef", "neurlz_grad_archive", "compressed_psum", "bf16_psum"]
