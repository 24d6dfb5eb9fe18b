"""Model zoo (port of repro.models): all ten registered architectures --
attention (dense, local, cross), mixture-of-experts, RG-LRU and xLSTM
layers, whisper's encoder."""
from . import (attention, decode, layers, moe, recurrent, sharding,
               transformer, xlstm)
from .transformer import Transformer, forward, init_model, loss_fn
from .decode import decode_step, init_cache, prefill

__all__ = ["attention", "decode", "layers", "moe", "recurrent", "sharding",
           "transformer", "xlstm", "Transformer", "forward", "init_model",
           "loss_fn", "decode_step", "init_cache", "prefill"]
