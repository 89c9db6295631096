from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    global_norm)
from .compress import compress_grads, decompress_grads, init_error_feedback

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "compress_grads", "decompress_grads",
           "init_error_feedback"]
