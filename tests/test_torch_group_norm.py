"""The GroupNorm kernel's route, plan and plain version, on the CPU (the
kernel itself: tests/test_torch_cuda.py, on the card)."""
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from seed_tpu_torch.models import unclip as TU
from seed_tpu_torch.models.unclip import unet as TUN
from seed_tpu_torch.ops import group_norm as GN


def _stand_in(device="cuda", dtype=torch.bfloat16, shape=(2, 96, 96, 320),
              contiguous=True, ptr=0, sharded=False):
    x = SimpleNamespace(device=torch.device(device), dtype=dtype, shape=shape,
                        is_contiguous=lambda: contiguous, data_ptr=lambda: ptr)
    if sharded:
        x.device_mesh = object()        # what parallel.local.is_sharded reads
    return x


# (stand-in arguments, groups, takes the kernel): the UNet's widest level-0
# input, its mid block, the VAE's 768x768 level; the TINY models' 8 channels
# in 4 groups; fp32, the CPU, a non-contiguous view, a DTensor, C not a
# multiple of the groups, C not a multiple of 8, C past MAX_CHANNELS, more
# groups than MAX_GROUPS, an address off 16 bytes and an empty batch stay on
# the plain chain
ROUTE_CASES = [
    ({"shape": (2, 96, 96, 960)}, 32, True),
    ({"shape": (2, 12, 12, 2560)}, 32, True),
    ({"shape": (1, 768, 768, 128)}, 32, True),
    ({"shape": (2, 8, 8, 8)}, 4, True),
    ({"dtype": torch.float32}, 32, False),
    ({"device": "cpu"}, 32, False),
    ({"contiguous": False}, 32, False),
    ({"sharded": True}, 32, False),
    ({"shape": (2, 96, 96, 320)}, 30, False),
    ({"shape": (2, 8, 8, 36)}, 4, False),
    ({"shape": (1, 8, 8, 4096)}, 32, False),
    ({"shape": (2, 8, 8, 640)}, 128, False),
    ({"ptr": 2}, 32, False),
    ({"shape": (0, 96, 96, 320)}, 32, False),
]


@pytest.mark.parametrize("kw,groups,takes", ROUTE_CASES)
def test_group_norm_route_decides_from_the_input(kw, groups, takes):
    """unet.group_norm's choice reads only the input's device, dtype,
    shape, layout and address (stand-ins here: no card is needed)."""
    assert GN.group_norm_route(_stand_in(**kw), groups) is takes


# every (B, H * W, C) of the de-tokenizer cell: the UNet at CFG batch 2, the
# VAE at B=1
UNET_SHAPES = [(2, n, c) for n, cs in (
    (9216, (320, 640, 960)), (2304, (320, 640, 960, 1280, 1920)),
    (576, (640, 1280, 1920, 2560)), (144, (1280, 2560)))
    for c in cs]
VAE_SHAPES = [(1, 96 * 96, 512), (1, 192 * 192, 512), (1, 384 * 384, 512),
              (1, 384 * 384, 256), (1, 768 * 768, 256), (1, 768 * 768, 128)]


@pytest.mark.parametrize("B,N,C", UNET_SHAPES + VAE_SHAPES)
def test_group_norm_plan_fills_the_card(B, N, C):
    """Slices up to RESIDENT_BYTES take the resident design, one block a
    (sample, group); the rest stream: a block reads whole rows within 384
    threads, every block gets at least one chunk, and the batch's blocks
    cover every SM and at most two blocks an SM (the UNet's 9,216-position
    level and the VAE included)."""
    resident, R, U, Sb = GN.group_norm_plan(B, N, C, 32)
    assert resident == (N * C // 32 * 2 <= GN.RESIDENT_BYTES)
    if resident:
        assert (R, U, Sb) == (0, 0, 0)
        return
    chunks = -(-N // (R * U))
    assert (R, U, Sb) == GN.streaming_plan(B, N, C)
    assert U in GN.ROWS_PER_THREAD and R * C // 8 <= GN.MAX_THREADS
    assert R == max(1, GN.MAX_THREADS // (C // 8))
    assert 1 <= Sb <= chunks
    assert GN.SMS <= B * Sb <= GN.SMS * GN.BLOCKS_PER_SM + B


@pytest.mark.parametrize("B,N,C", UNET_SHAPES)
def test_streaming_plan_fills_the_card_at_every_unet_shape(B, N, C):
    """The streaming plan alone, at the UNet's shapes that the resident
    design takes too (the 144-position levels included): every SM gets a
    block."""
    R, U, Sb = GN.streaming_plan(B, N, C)
    assert 1 <= Sb <= -(-N // (R * U))
    assert GN.SMS <= B * Sb <= GN.SMS * GN.BLOCKS_PER_SM + B


def _norm_inputs(dtype, C=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (3 + 2 * torch.randn(2, 5, 6, C, generator=g)).to(dtype)
    p = {"scale": torch.randn(C, generator=g).to(dtype),
         "bias": torch.randn(C, generator=g).to(dtype)}
    return p, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_silu_on_the_plain_path_is_silu_of_the_norm(dtype):
    """On the plain path ``silu=True`` is F.silu after the norm, bit for
    bit, so fusing the call sites moves no number off the card."""
    p, x = _norm_inputs(dtype)
    got = TUN.group_norm(p, x, 32, silu=True)
    assert got.dtype == dtype
    assert torch.equal(got, F.silu(TUN.group_norm(p, x, 32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_kernel_on_the_cpu_is_its_plain_version(dtype):
    """group_norm_kernel on a CPU tensor runs group_norm_plain, whose norm
    is unet.group_norm's bit for bit. With SiLU on the fp32 value before the
    one rounding it equals F.silu of the norm in fp32; in bf16 it differs
    from F.silu of the rounded norm by that rounding and the SiLU's (each
    within half an ulp, 2**-8 of the norm's |y|; the SiLU's slope is at
    most 1.1): within 2**-6 of |y| at every element."""
    p, x = _norm_inputs(dtype, seed=1)
    before = GN.group_norm_kernel.launches
    norm = GN.group_norm_kernel(x, p["scale"], p["bias"], 32)
    fused = GN.group_norm_kernel(x, p["scale"], p["bias"], 32, silu=True)
    assert GN.group_norm_kernel.launches == before
    assert torch.equal(norm, TUN.group_norm(p, x, 32))
    want = F.silu(norm)
    if dtype == torch.float32:
        assert torch.equal(fused, want)
    else:
        err = (fused.float() - want.float()).abs()
        assert (err <= 2.0 ** -6 * norm.float().abs()).all()
        assert not torch.equal(fused, want)


def _unet_norms(u):
    """(GroupNorms with SiLU, without) in one UNet pass: two a resnet and
    the output's; one a spatial transformer."""
    resnets = len(u.block_channels) * (2 * u.layers_per_block + 1) + 2
    blocks = sum(u.attn_levels) * (2 * u.layers_per_block + 1) + 1
    return 2 * resnets + 1, blocks


def _vae_norms(v):
    resnets = 2 + len(v.channel_mults) * (v.layers_per_block + 1)
    return 2 * resnets + 1, 1


def test_norm_counts_of_the_sd21_de_tokenizer():
    """61 GroupNorms a UNet pass (45 with SiLU) and 30 a VAE decode (29)."""
    assert _unet_norms(TU.SD21_UNCLIP.unet) == (45, 16)
    assert _vae_norms(TU.SD21_UNCLIP.vae) == (29, 1)


def test_bf16_unet_and_vae_take_the_kernel_where_the_route_opens(monkeypatch):
    """On the CPU the route is shut and no call reaches group_norm_kernel.
    Opened by the input alone, as it opens for bf16 on the card, every
    GroupNorm of a TINY bf16 UNet pass and VAE decode runs the kernel's
    plain version, with SiLU fused where the norm had one after it; the
    outputs stay within 5e-2 of the shut route's (each norm within a bf16
    ulp: one rounding, not two)."""
    cfg = TU.TINY_UNCLIP
    gen = torch.Generator().manual_seed(2)
    params = TU.init_unclip(gen, cfg, torch.bfloat16, device="cpu")
    lat = torch.randn((2, 8, 8, 4), generator=gen).bfloat16()
    ctx = torch.randn((2, 4, cfg.unet.cross_attention_dim),
                      generator=gen).bfloat16()
    labels = torch.randn((2, cfg.unet.class_embed_input_dim),
                         generator=gen).bfloat16()
    t = torch.tensor([17, 901])
    calls = []
    kernel = GN.group_norm_kernel
    monkeypatch.setattr(TUN, "group_norm_kernel",
                        lambda x, s, b, g, eps, silu:
                        calls.append(silu) or kernel(x, s, b, g, eps, silu))

    def run():
        with torch.inference_mode():
            return (TU.unet_apply(params["unet"], lat, t, ctx, labels,
                                  cfg.unet),
                    TU.vae_decode(params["vae"], lat, cfg.vae))

    shut = run()
    assert not calls
    monkeypatch.setattr(TUN, "group_norm_route", lambda x, groups: True)
    opened = run()
    n_unet = sum(_unet_norms(cfg.unet))
    assert len(calls) == n_unet + sum(_vae_norms(cfg.vae))
    assert (sum(calls[:n_unet]), sum(calls[n_unet:])) == (
        _unet_norms(cfg.unet)[0], _vae_norms(cfg.vae)[0])
    for got, want in zip(opened, shut):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        assert rel <= 5e-2, rel
