"""The LM model zoo (port of ``repro.models``): attention (global /
local / chunked, and MLA), RG-LRU layers (recurrentgemma), Mamba-2 SSD
layers (mamba2), MoE FFNs (deepseek-v2, llama4) and the audio / vision
frontends."""
from .convert import (params_from_numpy, params_to_numpy,
                      train_state_from_numpy)
from .model import (apply_blocks, block_structure, decode_step, final_hidden,
                    forward, init_cache, init_params, layer_specs,
                    logits_from_hidden, prefill)

__all__ = [
    "apply_blocks", "block_structure", "decode_step", "final_hidden",
    "forward", "init_cache", "init_params", "layer_specs",
    "logits_from_hidden", "params_from_numpy", "params_to_numpy", "prefill",
    "train_state_from_numpy",
]
