from .model import (ModelConfig, decode_step, encode, forward, init_cache,
                    init_params, loss_fn, prefill, recurrent_leaves,
                    tree_leaves, tree_map, ATTN, DENSE, MAMBA, MOE_DENSE,
                    MOE_MLP as MOE, NONE)

__all__ = ["ModelConfig", "init_params", "init_cache", "encode", "forward",
           "loss_fn", "decode_step", "prefill", "recurrent_leaves",
           "tree_leaves", "tree_map", "ATTN", "DENSE", "MAMBA", "MOE",
           "MOE_DENSE", "NONE"]
