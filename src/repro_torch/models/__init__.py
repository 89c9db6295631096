from .model import (ModelConfig, decode_step, init_cache, init_params,
                    prefill, ATTN, DENSE)

__all__ = ["ModelConfig", "init_params", "init_cache", "decode_step",
           "prefill", "ATTN", "DENSE"]
