"""The launch plan of the port's int8-weight matmul kernel, and its plain
version against seed_tpu at a K with a ragged split, on the CPU.

``int8_plan`` is pure Python: the CUDA kernel (csrc/int8_matmul.cu) takes its
tile and its split of K from it and refuses any other, so what the card will
launch is checked here. seed_tpu's Pallas kernel runs in interpret mode, as
tests/test_torch_ops.py runs it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_tpu.ops import int8_matmul as JI
from seed_tpu_torch.ops import int8_matmul as TI

# (K, N) of the 8B's int8 linears: q/k/v/o, gate/up, down, lm_head
PREFILL = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 40320)]


@pytest.mark.parametrize("M", [256, 512])
@pytest.mark.parametrize("K,N", PREFILL)
def test_plan_fills_the_card_at_the_prefill_shapes(M, K, N):
    """At least one full wave of blocks (one per SM of the H100) at each
    prefill shape of the 256 and 512 buckets, the kernels' tile."""
    tile_m, tile_n, split = TI.int8_plan(M, N, K, torch.bfloat16)
    assert (tile_m, tile_n) == TI.TILES[torch.bfloat16]
    blocks = -(-M // tile_m) * (N // tile_n) * split
    assert blocks >= TI.SMS
    assert 1 <= split <= min(TI.MAX_SPLIT, K // TI.K_CHUNK)


@pytest.mark.parametrize("M", [1, 256, 300, 512])
@pytest.mark.parametrize("K,N", PREFILL + [(128, 256), (512, 384)])
def test_every_split_covers_k_in_whole_chunks(M, K, N):
    """The plan's split, and every split the kernel takes at this K, cut K
    into adjacent runs of whole 128-wide chunks, none empty; the workspace
    holds one fp32 [M, N] partial per split, none when unsplit."""
    _, _, planned = TI.int8_plan(M, N, K, torch.bfloat16)
    for split in sorted({planned, *range(1, min(TI.MAX_SPLIT, K // 128) + 1)}):
        bounds = TI.int8_split_bounds(K, split)
        assert len(bounds) == split
        assert bounds[0][0] == 0 and bounds[-1][1] == K
        for (b0, e0), (b1, _) in zip(bounds, bounds[1:]):
            assert e0 == b1
        for b, e in bounds:
            assert e > b and b % 128 == 0 and e % 128 == 0
        want = 0 if split == 1 else split * M * N
        assert TI.int8_workspace(M, N, split) == want


@pytest.mark.parametrize("M", [256, 300, 512, 2048])
@pytest.mark.parametrize("K,N", PREFILL)
def test_fp32_plan_fills_the_card_and_covers_k(M, K, N):
    """fp32 x (int8_mm_f32) plans on its own 64 x 128 tile: at least one
    full wave of blocks at the prefill shapes, a split the kernel takes, and
    runs of whole 128-wide chunks that cover K once."""
    tile_m, tile_n, split = TI.int8_plan(M, N, K, torch.float32)
    assert (tile_m, tile_n) == TI.TILES[torch.float32] == (64, 128)
    assert -(-M // tile_m) * (N // tile_n) * split >= TI.SMS
    assert 1 <= split <= min(TI.MAX_SPLIT, K // TI.K_CHUNK)
    covered = [c for b, e in TI.int8_split_bounds(K, split)
               for c in range(b // 128, e // 128)]
    assert covered == list(range(K // 128))


def test_plan_splits_only_below_one_wave():
    """Enough output tiles on their own (two blocks per SM) take no split;
    the 4096 x 4096 and K = 11008 shapes at M = 256 do split, K = 11008 into
    runs of unequal chunk counts (86 chunks)."""
    assert TI.int8_plan(256, 40320, 4096, torch.bfloat16)[2] == 1
    assert TI.int8_plan(1024, 4096, 4096, torch.bfloat16)[2] == 1
    split = TI.int8_plan(256, 4096, 11008, torch.bfloat16)[2]
    assert split > 1
    sizes = {(e - b) // 128 for b, e in TI.int8_split_bounds(11008, split)}
    assert sizes == ({86 // split} if 86 % split == 0
                     else {86 // split, 86 // split + 1})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_at_k_11008_with_ragged_m(dtype):
    """K = 11008 (86 chunks: a ragged split on the card; 43 K tiles of 256 on
    the Pallas side) with M = 260 (a ragged M tile on both sides). fp32: sum
    order only (1e-5 of max|y|); bf16: one output rounding apart (2**-7)."""
    M, K, N = 260, 11008, 128
    rs = np.random.RandomState(11008)
    x = rs.randn(M, K).astype(np.float32)
    wq = rs.randint(-127, 128, (K, N)).astype(np.int8)
    scale = (np.abs(rs.randn(N)) * 0.01).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.array(jnp.asarray(JI.int8_matmul(jx, jnp.asarray(wq),
                                               jnp.asarray(scale)), jnp.float32))
    tx = torch.from_numpy(np.array(jnp.asarray(jx, jnp.float32))).to(getattr(torch, dtype))
    got = TI.int8_matmul(tx, torch.from_numpy(wq), torch.from_numpy(scale))
    assert got.dtype == tx.dtype and got.shape == (M, N)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max()
