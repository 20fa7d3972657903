"""The control: the plain reference one precision below the configuration's
(every projection's input rounded to fp8 e4m3), put in the program's place,
has to fail the cell's check. On the card at each cell's own size and three
seeds; on the CPU, at a tiny size, that the tokenizer's reads above the
sound program's."""
import pytest
import torch

from h100bench.core import bench

from test_h100bench_faults import tiny_tokenizer

M = bench.load_manifest()
SEEDS = (2147483931, 2147483932, 2147483933)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("wname", [w["name"] for w in M["workloads"]])
def test_control_fails_the_check_on_the_card(card, wname):
    w = bench.workload(M, wname)
    limits = bench.data("configs", w["config"])["check"]
    for seed in SEEDS:
        row = bench.readings(M, wname, seed, 20.0, control=True)
        assert all(v <= limits[k] for k, v in row["checks"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()
                   if k in limits), row


def test_control_reads_above_the_program_at_a_tiny_size():
    """The tokenizer's feature error is continuous; the LLM's widest gap is
    0 wherever no token flips, as at this size, so the card test alone
    holds the LLM's control."""
    cfg, mix = tiny_tokenizer()
    row = bench.readings(M, "tok-pretok-b256", 2147483939, 1.0, mix=mix,
                         config=cfg, control=True, device="cpu")
    assert row["control"]["feature_err"] > row["checks"]["feature_err"], row
