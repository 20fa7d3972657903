from .losses import (IGNORE_INDEX, cosine_recon_loss, cross_entropy,
                     info_nce, mse_loss, next_token_loss)
from .lora import (apply_lora, init_lora, merge_lora_weights, split_trainable)
from .optim import (adamw, cosine_with_floor,
                    learnable_image_embeddings_only, masked_trainable,
                    warmup_cosine, warmup_step_decay)
from .trainer import Trainer, TrainerConfig, TrainState, make_train_step

__all__ = [
    "IGNORE_INDEX", "cosine_recon_loss", "cross_entropy", "info_nce",
    "mse_loss", "next_token_loss",
    "apply_lora", "init_lora", "merge_lora_weights", "split_trainable",
    "adamw", "cosine_with_floor", "learnable_image_embeddings_only",
    "masked_trainable", "warmup_cosine", "warmup_step_decay",
    "Trainer", "TrainerConfig", "TrainState", "make_train_step",
]
