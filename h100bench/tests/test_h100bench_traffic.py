"""The default traffic generator: deterministic per seed, the same work
for every seed, within the deployment's limits; a mix that names a
generator of its own is read by it."""
import collections

import numpy as np
import pytest

from h100bench.core import bench, traffic as T

MIXES = ["chat-poisson"]


def _mix(name):
    return bench.data("traffic", name)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a = T.open_loop(_mix(name), 2147483901, 20, 102400, 2048)
    b = T.open_loop(_mix(name), 2147483901, 20, 102400, 2048)
    assert [(r.due_s, r.prompt, r.max_new_tokens, r.greedy, r.forced_first)
            for r in a] == \
        [(r.due_s, r.prompt, r.max_new_tokens, r.greedy, r.forced_first)
         for r in b]


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_sizes_and_gaps(name):
    """Two seeds offer the same multiset of sizes and of gaps, in another
    order, so they differ in order and content, not in work."""
    a = T.open_loop(_mix(name), 1, 20, 102400, 4096)
    b = T.open_loop(_mix(name), 2 ** 31 + 17, 20, 102400, 4096)
    for size in (lambda r: len(r.prompt), lambda r: r.max_new_tokens,
                 lambda r: r.forced_first):
        assert collections.Counter(map(size, a)) == \
            collections.Counter(map(size, b))
    gaps = lambda rs: sorted(np.round(np.diff([r.due_s for r in rs]), 9))
    assert len(a) == len(b)
    assert sum(r.greedy for r in a) == sum(r.greedy for r in b)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    # the gaps differ only in which one is last (the schedule's tail)
    assert np.allclose(sorted(gaps(a))[:-1], sorted(gaps(b))[:-1],
                       rtol=0, atol=max(gaps(a)) + 1e-9)


@pytest.mark.parametrize("name", MIXES)
def test_offered_rate_and_limits(name):
    mix = _mix(name)
    s = T.open_loop(mix, 5, 30, 102400, 2048)
    span = mix["lead_in_s"] + 30
    assert len(s) == round(mix["rate_per_s"] * span)
    assert all(0 <= r.due_s < span for r in s)
    assert all(len(r.prompt) + r.max_new_tokens <= 2046 for r in s)
    assert all(3 <= t < 102400 for r in s for t in r.prompt)


def test_lengths_are_quantiles():
    d = {"dist": "lognormal", "median": 320, "sigma": 0.8, "min": 32,
         "max": 1536}
    x = T.lengths(d, 1001)
    assert x[500] == 320 and x.min() >= 32 and x.max() <= 1536
    u = T.lengths({"dist": "uniform", "min": 8, "max": 32}, 25)
    assert sorted(u) == list(range(8, 33))


def test_poisson_gaps_keep_the_mean():
    g = T.gaps(4.0, 400)
    assert abs(g.mean() - 0.25) < 1e-9
    assert abs(g.std() / g.mean() - 1.0) < 0.1


def test_default_generator():
    assert bench.open_loop(_mix("chat-poisson")) is T.open_loop


def test_a_mix_names_its_own_generator(tmp_path, monkeypatch):
    """A traffic shape the default generator does not build comes as a new
    file under ``generators/``, found by the name the mix gives."""
    (tmp_path / "bursts.py").write_text(
        "from h100bench.core.traffic import Request\n"
        "def open_loop(mix, seed, seconds, vocab, max_len):\n"
        "    return [Request(i, 0.5 * i, [3] * mix['n'], 4, True, False)\n"
        "            for i in range(seed)]\n")
    monkeypatch.setattr(bench, "GENERATORS", tmp_path)
    mix = {"generator": "bursts", "n": 7}
    reqs = bench.open_loop(mix)(mix, 3, 10, 100, 64)
    assert [(r.due_s, len(r.prompt)) for r in reqs] == [(0.0, 7), (0.5, 7),
                                                        (1.0, 7)]
