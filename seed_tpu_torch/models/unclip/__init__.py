"""The unCLIP de-tokenizer (counterpart of seed_tpu/models/unclip): DDIM
UNet + VAE decoder that turn the SEED tokenizer's image embedding into
pixels, and the CLIP text tower of its empty-prompt context."""
from .clip_text import (CLIPTextConfig, SD21_TEXT, TINY_TEXT, clip_text_apply,
                        init_clip_text)
from .pipeline import (SD21_UNCLIP, TINY_UNCLIP, UnCLIPConfig, UnCLIPDecoder,
                       decode_to_images, generate_latents, init_unclip,
                       noise_image_embeddings)
from .schedulers import DDIMScheduler, DDPMNoiser, timestep_embedding
from .unet import SD21_UNCLIP_UNET, TINY_UNET, UNetConfig, init_unet, unet_apply
from .vae import SD_VAE, TINY_VAE, VAEConfig, init_vae_decoder, vae_decode

__all__ = [
    "CLIPTextConfig", "SD21_TEXT", "TINY_TEXT", "clip_text_apply",
    "init_clip_text",
    "SD21_UNCLIP", "TINY_UNCLIP", "UnCLIPConfig", "UnCLIPDecoder",
    "decode_to_images", "generate_latents", "init_unclip",
    "noise_image_embeddings",
    "DDIMScheduler", "DDPMNoiser", "timestep_embedding",
    "SD21_UNCLIP_UNET", "TINY_UNET", "UNetConfig", "init_unet", "unet_apply",
    "SD_VAE", "TINY_VAE", "VAEConfig", "init_vae_decoder", "vae_decode",
]
