"""The launch plan of the port's fp32 short_mha kernel, and the kernel's
function at its tile-edge shapes against seed_tpu, on the CPU.

``short_mha_f32_plan`` and ``short_mha_f32_tiles`` are pure Python mirrors of
``f32_groups_per_tile`` and the kernel's tile split in csrc/short_mha.cu; the
wrapper checks the mirror against the library before each new shape, so what
the card will launch is checked here over the whole domain that
``flash_attention`` routes to the kernel (Sq, Sk <= 1024, D <= 256).
seed_tpu's ``_short_mha`` (a Pallas kernel) runs in interpret mode, as
tests/test_torch_ops.py runs it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_tpu.ops import flash_attention as JF
from seed_tpu_torch.ops import flash_attention as TF

# the EVA-ViT encode and tokenizer training (S=257, D=88), the longest and
# widest routed call, and the corners of the routed domain
NAMED = [(257, 257, 88), (1024, 1024, 256), (1024, 1024, 88), (1, 1, 1),
         (1, 1024, 256), (1024, 1, 1), (65, 65, 88), (257, 257, 128)]


def _sampled(n, seed):
    rng = np.random.RandomState(seed)
    return [tuple(int(x) for x in rng.randint(1, hi + 1, size=n))
            for hi in (1024, 1024, 256)]


def _check_plan(sq, sk, d):
    rows, smem = TF.short_mha_f32_plan(sq, sk, d)
    assert rows % TF.F32_GROUP == 0 and TF.F32_GROUP <= rows <= 64
    assert smem <= TF.SMEM_LIMIT
    tiles = TF.short_mha_f32_tiles(sq, rows)
    groups = -(-sq // TF.F32_GROUP)
    assert len(tiles) == -(-groups // (rows // TF.F32_GROUP))
    start = 0
    for r0, n in tiles:
        assert r0 == start and 1 <= n <= rows and r0 % TF.F32_GROUP == 0
        start += n
    assert start == sq
    # tiles differ by at most one row group (no near-empty tile)
    sizes = [-(-n // TF.F32_GROUP) for _, n in tiles]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("sq,sk,d", NAMED)
def test_plan_fits_and_covers_the_named_shapes(sq, sk, d):
    _check_plan(sq, sk, d)


@pytest.mark.parametrize("seed", range(4))
def test_plan_fits_and_covers_the_routed_domain(seed):
    """200 seeded (Sq, Sk, D) per case over Sq, Sk in 1..1024, D in 1..256:
    shared memory within a block's, at least one row group a tile, the
    tiles contiguous and covering Sq."""
    for sq, sk, d in zip(*_sampled(200, seed)):
        _check_plan(sq, sk, d)


def test_stage1_shape_runs_two_blocks_an_sm_with_little_waste():
    """B=16 S=257 H=16 D=88: 64-row tiles of 4 + 4 + 3 + 3 + 3 row groups
    (272 row slots for 257 rows), and shared memory for two blocks on one
    SM (228 KiB, 1 KiB of it reserved per block)."""
    rows, smem = TF.short_mha_f32_plan(257, 257, 88)
    assert (rows, smem) == (64, 114944)
    assert 2 * (smem + 1024) <= 228 * 1024
    assert TF.short_mha_f32_tiles(257, rows) == [(0, 64), (64, 64), (128, 48),
                                                (176, 48), (224, 33)]


def test_plan_takes_fewer_rows_where_64_do_not_fit():
    """Sk = 1024 at D = 256 or 88: two row groups a tile; Sq = 10: one."""
    assert TF.short_mha_f32_plan(1024, 1024, 256)[0] == 32
    assert TF.short_mha_f32_plan(1024, 1024, 88)[0] == 32
    assert TF.short_mha_f32_plan(10, 257, 88)[0] == 16


class _Library:
    """Stands in for the built library: its plan is the mirror's, or
    `delta` more shared memory."""

    def __init__(self, delta=0):
        self.delta = delta

    def seed_short_mha_f32_plan(self, sq, sk, d, which):
        rows, smem = TF.short_mha_f32_plan(sq, sk, d)
        return (rows, smem + self.delta, len(TF.short_mha_f32_tiles(sq, rows)))[which]


def test_a_stale_mirror_raises():
    current, stale = _Library(), _Library(delta=16)
    TF._check_f32_plan(current, 257, 257, 88)
    with pytest.raises(RuntimeError, match="mirror is stale"):
        TF._check_f32_plan(stale, 257, 257, 88)


@pytest.mark.parametrize("layout,d,want", [("fused", 88, 1), ("fused", 100, 1),
                                           ("fused", 33, 0), ("offset", 88, 0)])
def test_fp32_vec_staging_only_on_16_byte_rows(layout, d, want):
    """fp32 views split from one fused [B, S, 3 H D] projection stage 16
    bytes at a time when D, the strides and the addresses are multiples of
    4 floats; a view one element past an aligned base does not."""
    B, S, H = 1, 9, 3
    if layout == "fused":
        qkv = torch.zeros(B, S, 3 * H * d)
        q, k, v = (t.reshape(B, S, H, d) for t in qkv.split(H * d, dim=-1))
    else:
        q = k = v = torch.zeros(B * S * H * d + 1)[1:].view(B, S, H, d)
    assert TF._vec(q, (q, k, v)) == want


# (Sq, Sk, D): the fp32 card tests' tile edges: a 3-group and a 2-group
# tile, one row, Sq != Sk both ways, odd D, a zero slab of the 192 instance
EDGES = [(65, 65, 88), (1, 257, 88), (100, 300, 64), (300, 100, 64),
         (77, 77, 33), (130, 130, 160)]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("sq,sk,d", EDGES)
def test_short_mha_fp32_at_the_tile_edges_matches_pallas(sq, sk, d, exact):
    """On the CPU short_mha runs its plain version and counts no launch;
    against seed_tpu's _short_mha, 1e-5 (fp32 sum order only)."""
    rng = np.random.RandomState(sq + sk + d)
    q, k, v = (rng.randn(2, s, 2, d).astype(np.float32) for s in (sq, sk, sk))
    want = JF._short_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         d ** -0.5, exact)
    before = TF.short_mha.launches
    got = TF.short_mha(*(torch.from_numpy(a) for a in (q, k, v)), d ** -0.5, exact)
    assert TF.short_mha.launches == before
    assert got.shape == (2, sq, 2, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
