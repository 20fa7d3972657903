"""The default traffic generator: it turns a mix's data file
(``h100bench/traffic/<mix>.json``) and a seed into the requests of a run.
A mix that names ``"generator": "<name>"`` is read instead by
``h100bench/generators/<name>.py``'s ``open_loop`` (``core/bench.py``), so
a traffic shape this file does not build comes as a file of its own.

Open loop (``"loop": "open"``): requests arrive on a schedule, whatever the
system does. Every seed gets the same set of sizes and arrival gaps, in
another order: prompt and output lengths are the quantiles (i + 0.5) / n of
each class's distributions, and the gaps are those of a Poisson process,
scaled so that the schedule spans the lead-in and the window. The seed
shuffles them, picks which requests are greedy, and draws the
prompts' token ids. So two seeds differ in order and content, not in the
work they offer.

Keys of an open-loop mix:

- ``rate_per_s``: the fixed offered rate;
- ``lead_in_s``: seconds of arrivals before the window opens;
- ``classes``: each ``{"share", "prompt", "output"}`` and optionally
  ``"forced_first": true`` (the first token is forced, as an image
  generation forces BOI); a length is ``{"dist": "lognormal", "median",
  "sigma", "min", "max"}``, ``{"dist": "uniform", "min", "max"}`` or
  ``{"dist": "fixed", "value"}``;
- ``greedy_share``, ``temperature``, ``top_p``: sampling;
- ``profile``: ``{"start_s", "seconds"}``, the slice of the window the
  ``--trace 1`` run profiles.

Closed loop (``"loop": "closed"``): ``batch`` images a call from one
caller, ``pool`` distinct batches cycled, ``profile``: ``{"calls"}``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np


@dataclass
class Request:
    index: int
    due_s: float                 # from the schedule's origin
    prompt: List[int]
    max_new_tokens: int
    greedy: bool
    forced_first: bool


def _strata(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lengths(dist: dict, n: int) -> np.ndarray:
    """The n stratified quantiles of a length distribution, as ints."""
    u = _strata(n)
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, int(dist["value"]), np.int64)
    if kind == "uniform":
        lo, hi = int(dist["min"]), int(dist["max"])
        return np.minimum(lo + np.floor(u * (hi - lo + 1)), hi).astype(np.int64)
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        x = float(dist["median"]) * np.exp(float(dist["sigma"]) * z)
        return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {kind!r}")


def gaps(rate: float, n: int) -> np.ndarray:
    """n stratified exponential inter-arrival gaps of mean 1 / rate."""
    g = -np.log1p(-_strata(n))
    return g / g.mean() / rate


def _split(n: int, shares: List[float]) -> List[int]:
    """n items over shares by largest remainder."""
    raw = [n * s / sum(shares) for s in shares]
    out = [int(math.floor(r)) for r in raw]
    for i in sorted(range(len(raw)), key=lambda i: out[i] - raw[i])[
            :n - sum(out)]:
        out[i] += 1
    return out


def open_loop(mix: dict, seed: int, seconds: float, vocab: int,
              max_len: int) -> List[Request]:
    """The requests of one run, by due time. Prompt + output never exceed
    ``max_len - 2``, so each request ends by its own budget."""
    rate = float(mix["rate_per_s"])
    span = float(mix["lead_in_s"]) + float(seconds)
    n = max(1, int(round(rate * span)))
    rng = np.random.default_rng(seed)
    classes = mix["classes"]
    counts = _split(n, [c["share"] for c in classes])
    rows = []
    for c, k in zip(classes, counts):
        if k == 0:
            continue
        p = rng.permutation(lengths(c["prompt"], k))
        o = rng.permutation(lengths(c["output"], k))
        rows += [(int(a), int(b), bool(c.get("forced_first", False)))
                 for a, b in zip(p, o)]
    order = rng.permutation(n)
    rows = [rows[i] for i in order]
    g = rng.permutation(gaps(rate, n))
    g = g * (span / g.sum())
    due = np.concatenate([[0.0], np.cumsum(g)[:-1]])
    greedy = np.zeros(n, bool)
    greedy[rng.permutation(n)[:int(round(n * float(mix["greedy_share"])))]] = True
    out = []
    for i, (plen, olen, forced) in enumerate(rows):
        prompt = rng.integers(3, vocab, plen).tolist()[:max_len - 3]
        olen = max(1, min(olen, max_len - 2 - len(prompt)))
        out.append(Request(i, float(due[i]), prompt, olen, bool(greedy[i]),
                           forced))
    return out
