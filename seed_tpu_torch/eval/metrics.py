"""Evaluation metrics (counterpart of seed_tpu/eval/metrics.py): FID, the
Inception Score, VQA accuracy, and self-contained corpus BLEU-1..4 and
CIDEr-D for the caption eval loop, without scipy or pycocoevalcap. Plain
Python and numpy: features and probabilities come to the host first.

- ``frechet_distance``: the Gaussian W2 distance of FID (Dowson-Landau),
  with the reference's guards (eps on singular covariances);
- feature extraction is pluggable: any (images -> [N, D]) callable, such as
  ``eval.inception.inception_pool3``;
- ``inception_score`` from class probabilities.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


# ------------------------------- FID ----------------------------------------

def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def _sqrtm_psd(mat: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Matrix square root through the symmetric eigendecomposition."""
    sym = (mat + mat.T) / 2
    vals, vecs = np.linalg.eigh(sym)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)) (fid_score.py math)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # sqrt(s1 s2) = sqrt(sqrt(s1) s2 sqrt(s1)), which keeps it symmetric
    s1_half = _sqrtm_psd(sigma1)
    inner = s1_half @ sigma2 @ s1_half
    if not np.isfinite(inner).all():     # near-singular: the reference's eps
        offset = np.eye(sigma1.shape[0]) * eps
        s1_half = _sqrtm_psd(sigma1 + offset)
        inner = s1_half @ (sigma2 + offset) @ s1_half
    covmean = _sqrtm_psd(inner)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid(real_features: np.ndarray, fake_features: np.ndarray) -> float:
    m1, s1 = gaussian_stats(real_features)
    m2, s2 = gaussian_stats(fake_features)
    return frechet_distance(m1, s1, m2, s2)


def inception_score(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """probs [N, C] class probabilities -> (mean, std) of exp(KL)."""
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


# --------------------------- caption metrics --------------------------------

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


def vqa_accuracy(results: List[Dict], annotations: Dict[Any, List[str]]
                 ) -> Dict[str, float]:
    """VQA-style accuracy (eval/eval_vqa.py): min(matches / 3, 1) over the
    annotators' answers, with a light normalization of the strings."""
    def norm(s):
        return " ".join(str(s).lower().strip().strip(".").split())

    accs = []
    for r in results:
        gts = annotations.get(r.get("question_id", r.get("image_id")))
        if gts is None:
            continue
        pred = norm(r["answer"])
        matches = sum(1 for g in gts if norm(g) == pred)
        accs.append(min(matches / 3.0, 1.0))
    return {"vqa_accuracy": float(np.mean(accs)) if accs else 0.0,
            "num_evaluated": float(len(accs))}


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
