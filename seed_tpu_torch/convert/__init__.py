"""Released PyTorch checkpoints -> seed_tpu_torch param trees (counterpart
of seed_tpu/convert). The command line is ``python3 -m
seed_tpu_torch.convert <family> <src> <dst>`` (``convert/__main__.py``)."""
from .torch_convert import (convert_inception_torch, convert_llama,
                            convert_lora, convert_quantizer,
                            load_torch_state_dict)
from .unclip_convert import (convert_clip_text, convert_image_normalizer,
                             convert_unet, convert_vae_decoder)

__all__ = ["convert_inception_torch", "convert_llama", "convert_lora",
           "convert_quantizer", "load_torch_state_dict",
           "convert_clip_text", "convert_image_normalizer", "convert_unet",
           "convert_vae_decoder"]
