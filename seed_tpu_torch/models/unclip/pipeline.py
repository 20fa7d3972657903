"""unCLIP de-tokenizer pipeline: SEED image embedding -> pixels (counterpart
of seed_tpu/models/unclip/pipeline.py).

StableUnCLIPImg2ImgPipeline.__call__ restricted to the SEED use (precomputed
``image_embeds`` conditioning):

1. noise_image_embeddings: normalize -> DDPM add_noise at noise_level ->
   unnormalize -> concat the sinusoidal noise-level embedding (1024 -> 2048)
2. classifier-free guidance over the image embedding: uncond = zeros (or a
   negative embedding), cond and uncond batched in one UNet pass
3. DDIM v-prediction, 20 steps, guidance 10, 96x96x4 latents
4. VAE decode -> [0, 1] images, 768x768

The scheduler's tables are made on the device once per call, and the loop
indexes them there: the 20 steps enqueue their work without a host sync.

``UnCLIPDecoder`` replays the UNet pass as a CUDA graph, one captured on the
first call at each input shape (``CapturedUNetPass``), where eager dispatch
of its ~1,710 launches would hold the card back; guidance and the DDIM step
stay eager calls. It replays only with its weights resident on the card
(offloaded weights change address each call) and no profiler recording; on
the CPU, offloaded or under a profiler the pass runs eagerly, so that a
traced call records the pass's spans and launches its kernels one by one.

``UnCLIPDecoder.generate`` records one ``unclip.generate`` span a call
(counts ``images`` and ``steps``; recorded only under a profiler): the
embedding's noise, the CFG batch, the DDIM steps, guidance, the VAE and the
pixels' copy to the host, with the ``unet`` and ``vae`` spans inside.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ... import resolve_device
from ...utils.metrics_logging import _profiling, span
from .schedulers import DDIMScheduler, DDPMNoiser, timestep_embedding
from .unet import SD21_UNCLIP_UNET, TINY_UNET, UNetConfig, init_unet, unet_apply
from .vae import SD_VAE, TINY_VAE, VAEConfig, init_vae_decoder, vae_decode


@dataclass(frozen=True)
class UnCLIPConfig:
    unet: UNetConfig = SD21_UNCLIP_UNET
    vae: VAEConfig = SD_VAE
    scheduler: DDIMScheduler = DDIMScheduler()
    noiser: DDPMNoiser = DDPMNoiser()
    image_embed_dim: int = 1024
    latent_size: int = 96
    text_ctx_dim: int = 1024
    text_ctx_len: int = 77


SD21_UNCLIP = UnCLIPConfig()
TINY_UNCLIP = UnCLIPConfig(
    unet=TINY_UNET, vae=TINY_VAE, image_embed_dim=5, latent_size=8,
    text_ctx_dim=TINY_UNET.cross_attention_dim, text_ctx_len=4)


@torch.no_grad()
def init_unclip(gen: torch.Generator, cfg: UnCLIPConfig = SD21_UNCLIP,
                dtype=torch.float32, device="cuda"):
    """Seeded random de-tokenizer weights on ``device`` (the card by
    default); ``gen`` is a torch.Generator on that device."""
    device = resolve_device(device)
    return {
        "unet": init_unet(gen, cfg.unet, dtype, device),
        "vae": init_vae_decoder(gen, cfg.vae, dtype, device),
        # StableUnCLIPImageNormalizer (mean/std over the CLIP embedding)
        "image_normalizer": {
            "mean": torch.zeros((cfg.image_embed_dim,), dtype=dtype,
                                device=device),
            "std": torch.ones((cfg.image_embed_dim,), dtype=dtype,
                              device=device)},
        # cached empty-prompt text context ("" through the CLIP text tower);
        # python3 -m seed_tpu_torch.convert unclip fills it from a checkpoint
        "empty_prompt_embeds": torch.zeros(
            (1, cfg.text_ctx_len, cfg.text_ctx_dim), dtype=dtype, device=device),
    }


def noise_image_embeddings(params, image_embeds: torch.Tensor,
                           noise_level: int, noise: Optional[torch.Tensor],
                           cfg: UnCLIPConfig) -> torch.Tensor:
    """[B, D] -> [B, 2D]: noised embedding ++ noise-level embedding."""
    norm = params["image_normalizer"]
    mean, std = norm["mean"].float(), norm["std"].float()
    x = (image_embeds.float() - mean) / std
    if noise is None:
        noise = torch.zeros_like(x)
    ts = torch.full((x.shape[0],), noise_level, dtype=torch.int32,
                    device=x.device)
    x = cfg.noiser.add_noise(x, noise, ts)
    x = x * std + mean
    lvl = timestep_embedding(ts, image_embeds.shape[-1], flip_sin_to_cos=True,
                             downscale_freq_shift=0.0)
    return torch.cat([x, lvl], dim=1).to(image_embeds.dtype)


def generate_latents(params, image_embeds: torch.Tensor, latents: torch.Tensor,
                     cfg: UnCLIPConfig, num_inference_steps: int = 20,
                     guidance_scale: float = 10.0,
                     negative_image_embeds: Optional[torch.Tensor] = None,
                     noise_level: int = 0,
                     embed_noise: Optional[torch.Tensor] = None,
                     prompt_embeds: Optional[torch.Tensor] = None,
                     unet_pass: Callable = unet_apply) -> torch.Tensor:
    """Denoise loop -> final latents [B, h, w, 4] (pre-VAE). ``unet_pass``
    takes ``unet_apply``'s arguments and runs one pass of the CFG batch (a
    ``UNetGraphs.bind()`` replays a graph); its context and class
    labels stay the same over the loop's steps."""
    B = image_embeds.shape[0]
    cond = noise_image_embeddings(params, image_embeds, noise_level,
                                  embed_noise, cfg)
    if negative_image_embeds is not None:
        uncond = noise_image_embeddings(params, negative_image_embeds, 0,
                                        None, cfg)
    else:
        uncond = torch.zeros_like(cond)
    class_labels = torch.cat([uncond, cond], dim=0)     # CFG batch

    if prompt_embeds is None:
        prompt_embeds = params["empty_prompt_embeds"]
    ctx = prompt_embeds.expand(2 * B, *prompt_embeds.shape[-2:]).to(latents.dtype)

    ts, alpha_t, alpha_prev = cfg.scheduler.make_tables(num_inference_steps,
                                                        latents.device)
    x = latents * cfg.scheduler.init_noise_sigma
    for i in range(num_inference_steps):
        lat2 = torch.cat([x, x], dim=0)
        t = ts[i].expand(2 * B)
        pred = unet_pass(params["unet"], lat2, t, ctx, class_labels, cfg.unet)
        pu, pc = pred.chunk(2, dim=0)
        pred = pu + guidance_scale * (pc - pu)
        x = cfg.scheduler.step(pred, x, alpha_t[i], alpha_prev[i]).to(x.dtype)
    return x


def decode_to_images(params, latents: torch.Tensor,
                     cfg: UnCLIPConfig) -> torch.Tensor:
    imgs = vae_decode(params["vae"], latents / cfg.vae.scaling_factor, cfg.vae)
    return (imgs * 0.5 + 0.5).clamp(0.0, 1.0)   # [-1,1] -> [0,1]


def replays_unet(device: torch.device, offload: bool) -> bool:
    """Whether a decoder replays its captured UNet pass: on a CUDA device,
    with the weights resident (``offload`` False: offloaded weights are
    copied to new addresses each call), and with no profiler recording (a
    replay records no spans, and a traced call is read by them)."""
    return device.type == "cuda" and not offload and not _profiling()


def _static_like(x: torch.Tensor) -> torch.Tensor:
    """An empty buffer of x's shape, strides and dtype: a broadcast (stride 0)
    dim stays one, as the expanded empty-prompt context and timesteps are,
    so that the captured pass sees the eager pass's layouts."""
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device=x.device)


def _fill(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy ``src`` into ``dst`` of the same strides, a broadcast dim once."""
    for d, stride in enumerate(dst.stride()):
        if stride == 0:
            dst, src = dst.narrow(d, 0, 1), src.narrow(d, 0, 1)
    dst.copy_(src)


class CapturedUNetPass:
    """One UNet pass captured as a CUDA graph at one set of input shapes,
    strides and dtypes: static latents, timesteps, context and class labels,
    and the static prediction that a replay writes.

    Captured as ``torch.cuda.graphs`` documents it: one eager pass on a side
    stream first (it loads the kernels' libraries, lets cuDNN choose its
    algorithms and fills the allocator), then the capture on that stream
    into the graph's own memory pool. The capture errs only on this
    thread's unsafe calls, so an LLM engine's thread may run beside it. It
    reads the weights in place: ``params`` must stay where they are."""

    def __init__(self, params, cfg: UNetConfig, *inputs: torch.Tensor):
        self.inputs = [_static_like(x) for x in inputs]
        for dst, src in zip(self.inputs, inputs):
            _fill(dst, src)
        caller = torch.cuda.current_stream(inputs[0].device)
        side = torch.cuda.Stream(inputs[0].device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            unet_apply(params, *self.inputs, cfg)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self.pred = unet_apply(params, *self.inputs, cfg)
        caller.wait_stream(side)


class UNetGraphs:
    """The captured UNet passes of one decoder, keyed by their inputs'
    shapes, strides and dtypes: the CFG batch 2B, the latents, the context's
    length. Each is captured on the first call that meets its key."""

    def __init__(self):
        self.graphs: Dict[tuple, CapturedUNetPass] = {}

    def bind(self) -> Callable:
        """A pass function for one denoise loop (``generate_latents``'s
        ``unet_pass``). Its first call finds or captures the graph of its
        inputs and copies the context and class labels in; every call copies
        the latents and timesteps in and replays. It returns the static
        prediction, which the next replay overwrites: the loop reads it
        before, in stream order."""
        graph = None

        def unet_pass(params, lat2, t, ctx, class_labels, cfg):
            nonlocal graph
            if graph is None:
                inputs = (lat2, t, ctx, class_labels)
                key = tuple((x.shape, x.stride(), x.dtype) for x in inputs)
                graph = self.graphs.get(key)
                if graph is None:
                    graph = self.graphs[key] = CapturedUNetPass(params, cfg,
                                                                *inputs)
                _fill(graph.inputs[2], ctx)
                _fill(graph.inputs[3], class_labels)
            _fill(graph.inputs[0], lat2)
            _fill(graph.inputs[1], t)
            graph.graph.replay()
            return graph.pred

        return unet_pass


class UnCLIPDecoder:
    """The serving-side de-tokenizer (the diffusion half of ImageTokenizer).

    Holds the fixed latents the reference decodes from
    (seed_llama_tokenizer.py:61-65). seed_tpu draws them from
    ``jax.random.PRNGKey(seed)``, a stream torch cannot repeat; here they come
    from ``torch.Generator(device).manual_seed(seed)``, and tests that hold
    the two packages together set ``latents`` explicitly. ``offload=True``
    keeps the weights in pinned host memory between calls
    (serving/offload.py). Where ``replays_unet`` holds, ``generate`` replays
    the UNet pass from ``unet_graphs``, one call at a time, as the calls
    share the graphs' static buffers.
    """

    def __init__(self, params, cfg: UnCLIPConfig = SD21_UNCLIP,
                 num_inference_steps: int = 20, guidance_scale: float = 10.0,
                 dtype=torch.bfloat16, seed: int = 42, offload: bool = False,
                 device="cuda"):
        from ...serving.offload import wrap_params
        self.device = resolve_device(device)
        self._params = wrap_params(params, offload, self.device)
        self.params = self._params.params
        self.offload = offload
        self.unet_graphs = UNetGraphs()
        self._replay_lock = threading.Lock()
        self.cfg = cfg
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = guidance_scale
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.latents = torch.randn(
            (1, cfg.latent_size, cfg.latent_size, 4), generator=gen,
            device=self.device).to(dtype)

    @torch.inference_mode()
    def generate(self, image_embeds) -> np.ndarray:
        """[B, 1024] unCLIP embeddings -> float32 images [B, H, W, 3] in
        [0, 1], decoded from the same latents for every image."""
        emb = torch.as_tensor(image_embeds, device=self.device)
        lat = self.latents.expand(emb.shape[0], *self.latents.shape[1:])
        replay = replays_unet(self.device, self.offload)
        with span("unclip.generate", lat, images=emb.shape[0],
                  steps=self.num_inference_steps), self._params as p:
            with self._replay_lock if replay else contextlib.nullcontext():
                lat = generate_latents(
                    p, emb, lat, self.cfg, self.num_inference_steps,
                    self.guidance_scale, unet_pass=(
                        self.unet_graphs.bind() if replay else unet_apply))
            # the host copy syncs before release
            return decode_to_images(p, lat, self.cfg).float().cpu().numpy()
