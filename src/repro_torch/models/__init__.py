"""The LM model zoo (port of ``repro.models``): the recurrentgemma slice —
dense attention (global / local / chunked) and RG-LRU layers."""
from .convert import params_from_numpy
from .model import (apply_blocks, block_structure, decode_step, final_hidden,
                    forward, init_cache, init_params, layer_specs,
                    logits_from_hidden, prefill)

__all__ = [
    "apply_blocks", "block_structure", "decode_step", "final_hidden",
    "forward", "init_cache", "init_params", "layer_specs",
    "logits_from_hidden", "params_from_numpy", "prefill",
]
