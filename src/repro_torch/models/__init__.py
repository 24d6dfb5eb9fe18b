"""Model zoo (port of repro.models): the attention-only dense family."""
from . import attention, decode, layers, transformer
from .transformer import Transformer, forward, init_model
from .decode import decode_step, init_cache, prefill

__all__ = ["attention", "decode", "layers", "transformer", "Transformer",
           "forward", "init_model", "decode_step", "init_cache", "prefill"]
