"""Training of the port: AdamW, the train step and loop, and gradient
compression (``repro.train``'s)."""
from .optimizer import OptConfig, apply_updates, init_opt_state, lr_at
from .train_loop import (TrainConfig, init_train_state, make_train_step,
                         train_loop)
from .grad_compress import (compress_with_feedback, compressed_psum,
                            dequantize, quantize)

__all__ = ["OptConfig", "apply_updates", "init_opt_state", "lr_at",
           "TrainConfig", "init_train_state", "make_train_step", "train_loop",
           "compress_with_feedback", "compressed_psum", "dequantize",
           "quantize"]
