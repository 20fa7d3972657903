"""Caption metrics (counterpart of the caption half of
seed_tpu/eval/metrics.py): self-contained corpus BLEU-1..4 and CIDEr-D for
the caption eval loop, without pycocoevalcap. Plain Python and numpy.
FID and the Inception Score come with the rest of ``eval/``."""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

import numpy as np


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu(candidates: List[str], references: List[List[str]],
         max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n with the standard brevity penalty."""
    p_num = [0] * max_n
    p_den = [0] * max_n
    cand_len, ref_len = 0, 0
    for cand, refs in zip(candidates, references):
        c = cand.lower().split()
        rs = [r.lower().split() for r in refs]
        cand_len += len(c)
        ref_len += min((abs(len(r) - len(c)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            cn = _ngrams(c, n)
            maxref = Counter()
            for r in rs:
                for g, cnt in _ngrams(r, n).items():
                    maxref[g] = max(maxref[g], cnt)
            p_num[n - 1] += sum(min(cnt, maxref[g]) for g, cnt in cn.items())
            p_den[n - 1] += max(1, sum(cn.values()))
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(1, cand_len))
    out = []
    logsum = 0.0
    for n in range(max_n):
        p = p_num[n] / max(1, p_den[n])
        logsum += math.log(p + 1e-12)
        out.append(bp * math.exp(logsum / (n + 1)))
    return out


def cider_d(candidates: List[str], references: List[List[str]],
            max_n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D: tf-idf weighted n-gram cosine with a length penalty."""
    df: Dict[tuple, float] = defaultdict(float)    # over reference sets
    ref_tokens = [[r.lower().split() for r in refs] for refs in references]
    for refs in ref_tokens:
        seen = set()
        for r in refs:
            for n in range(1, max_n + 1):
                seen |= set(_ngrams(r, n).keys())
        for g in seen:
            df[g] += 1.0
    log_num_imgs = math.log(max(1.0, len(references)))

    def tfidf_vec(tokens, n):
        cnt = _ngrams(tokens, n)
        total = max(1.0, float(sum(cnt.values())))
        vec = {}
        norm = 0.0
        for g, c in cnt.items():
            idf = log_num_imgs - math.log(max(1.0, df.get(g, 0.0)))
            w = (c / total) * idf
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm), len(tokens)

    scores = []
    for cand, refs in zip([c.lower().split() for c in candidates], ref_tokens):
        score = 0.0
        for n in range(1, max_n + 1):
            cv, cnorm, clen = tfidf_vec(cand, n)
            sim_sum = 0.0
            for r in refs:
                rv, rnorm, rlen = tfidf_vec(r, n)
                num = sum(min(cv[g], rv.get(g, 0.0)) * rv.get(g, 0.0)
                          for g in cv)
                penalty = math.exp(-((clen - rlen) ** 2) / (2 * sigma ** 2))
                if cnorm > 0 and rnorm > 0:
                    sim_sum += penalty * num / (cnorm * rnorm)
            score += sim_sum / max(1, len(refs))
        scores.append(10.0 * score / max_n)
    return float(np.mean(scores)) if scores else 0.0


def caption_metrics(results: List[Dict], annotations: Dict[int, List[str]]
                    ) -> Dict[str, float]:
    """The compute_metrics contract (trainer.py:331-364): ``results`` =
    [{"image_id": int, "caption": str}], ``annotations`` maps image_id ->
    reference captions."""
    cands, refs = [], []
    for r in results:
        if r["image_id"] in annotations:
            cands.append(r["caption"])
            refs.append(annotations[r["image_id"]])
    b = bleu(cands, refs)
    return {"BLEU-1": b[0], "BLEU-4": b[3], "CIDEr": cider_d(cands, refs),
            "num_evaluated": float(len(cands))}
