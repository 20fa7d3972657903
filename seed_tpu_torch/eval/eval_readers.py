"""Eval data readers: caption / VQA / image-edit / video streams
(counterpart of seed_tpu/eval/eval_readers.py; torchdata_eval.py:87-646 of
the reference, without torchdata).

Plain generators over json / jsonl annotation files that yield numpy pixel
batches with their question and answer strings. Corrupt images are skipped
(:280-284); the prompts are the reference's (:213-276). Video frames are
sampled as ``sample_frames`` (:345-360) does, from a directory of images, a
``.npy`` stack, or a video file when cv2 imports. Plain Python and numpy:
nothing here touches a device.
"""
from __future__ import annotations

import json
import os
import random
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

# the reference's eval prompts (torchdata_eval.py:213-276)
VQA_PROMPT_SUFFIX = (" Please provide an accurate answer consisting of only "
                     "one word or phrase.")
CAPTION_PROMPT = ("Please provide an accurate and concise description of the "
                  "given image.")
VIDEO_CAPTION_PROMPT = ("Please provide an accurate and concise description "
                        "of the given video.")


def iter_json_records(path: str) -> Iterator[Dict[str, Any]]:
    """Records of a .json list file or of a .jsonl file."""
    with open(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == "[":
            yield from json.load(f)
        else:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)


def _load_image(path: str, image_size: int) -> Optional[np.ndarray]:
    from PIL import Image
    try:
        img = Image.open(path).convert("RGB").resize((image_size, image_size))
    except (OSError, ValueError):
        return None     # corrupt or missing image: skip (torchdata_eval.py:280-284)
    return np.asarray(img, np.uint8)


def caption_eval_stream(ann_path: str, image_root: str = "",
                        image_size: int = 224, prompt: str = CAPTION_PROMPT
                        ) -> Iterator[Dict[str, Any]]:
    """COCO-caption-style eval (:249-252): yields {"question", "answer",
    "pixels", "image_id"}."""
    for i, rec in enumerate(iter_json_records(ann_path)):
        pix = _load_image(os.path.join(image_root, rec["image"]), image_size)
        if pix is None:
            continue
        answer = rec.get("caption", rec.get("answer", ""))
        if isinstance(answer, list):
            answer = answer[0] if answer else ""
        yield {"question": prompt, "answer": str(answer), "pixels": pix,
               "image_id": rec.get("image_id", i)}


def vqa_eval_stream(ann_path: str, image_root: str = "",
                    image_size: int = 224,
                    prompt_suffix: str = VQA_PROMPT_SUFFIX
                    ) -> Iterator[Dict[str, Any]]:
    """VQAv2 / OK-VQA / VizWiz-style eval (:219-236): the question with the
    one-word answer suffix; yields {"question", "answer", "answers",
    "pixels", "question_id"}."""
    for i, rec in enumerate(iter_json_records(ann_path)):
        pix = _load_image(os.path.join(image_root, rec["image"]), image_size)
        if pix is None:
            continue
        answer = rec.get("answer", "")
        answers = ([str(a) for a in answer] if isinstance(answer, list)
                   else [str(answer)])
        yield {"question": str(rec["question"]) + prompt_suffix,
               "answer": answers[0] if answers else "",
               "answers": answers, "pixels": pix,
               "question_id": rec.get("question_id", i)}


def edit_eval_stream(ann_path: str, image_root: str = "",
                     image_size: int = 224) -> Iterator[Dict[str, Any]]:
    """InstructPix2Pix / MagicBrush-style edit eval (:307-344): yields
    {"instruction", "source_pixels", "target_pixels", "sample_id"}."""
    for i, rec in enumerate(iter_json_records(ann_path)):
        src = _load_image(os.path.join(image_root, rec["source_image"]),
                          image_size)
        tgt = _load_image(os.path.join(image_root, rec["target_image"]),
                          image_size)
        if src is None or tgt is None:
            continue
        yield {"instruction": str(rec["instruction"]), "source_pixels": src,
               "target_pixels": tgt, "sample_id": rec.get("sample_id", i)}


def sample_frames(num_frames: int, vlen: int, sample: str = "uniform",
                  fix_start: Optional[int] = None,
                  rng: Optional[random.Random] = None) -> List[int]:
    """Frame indices (torchdata_eval.py:345-360): [0, vlen) split into
    ``num_frames`` intervals; "uniform" takes their midpoints, "rand" one
    frame of each, ``fix_start`` the same offset into each."""
    rng = rng or random
    acc = min(num_frames, vlen)
    intervals = np.linspace(start=0, stop=vlen, num=acc + 1).astype(int)
    ranges = [(intervals[i], intervals[i + 1] - 1) for i in range(acc)]
    if sample == "rand":
        return [rng.choice(range(lo, max(hi, lo + 1))) for lo, hi in ranges]
    if fix_start is not None:
        return [lo + fix_start for lo, _ in ranges]
    if sample == "uniform":
        return [(lo + hi) // 2 for lo, hi in ranges]
    raise NotImplementedError(sample)


def load_video_frames(path: str, num_frames: int, image_size: int = 224,
                      sample: str = "uniform") -> Optional[np.ndarray]:
    """``num_frames`` sampled frames -> [T, H, W, 3] uint8, from a directory
    of frame images, an .npy [T, H, W, 3] stack, or a video file when cv2
    imports (read_frames_cv2, :362-386). None when a frame cannot be read."""
    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        idxs = sample_frames(num_frames, len(names), sample)
        frames = [_load_image(os.path.join(path, names[i]), image_size)
                  for i in idxs]
        if any(f is None for f in frames):
            return None
        return np.stack(frames)
    if path.endswith(".npy"):
        from PIL import Image
        arr = np.load(path)
        idxs = sample_frames(num_frames, arr.shape[0], sample)
        return np.stack([np.asarray(Image.fromarray(arr[i]).resize(
            (image_size, image_size)), np.uint8) for i in idxs])
    try:
        import cv2
    except ImportError:
        return None
    cap = cv2.VideoCapture(path)
    try:
        vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        frames = []
        for i in sample_frames(num_frames, vlen, sample):
            cap.set(cv2.CAP_PROP_POS_FRAMES, i - 1)
            ok, frame = cap.read()
            if ok:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                frames.append(cv2.resize(frame, (image_size, image_size)))
    finally:
        cap.release()
    return np.stack(frames) if frames else None


def video_eval_stream(ann_path: str, video_root: str = "",
                      image_size: int = 224, num_frames: int = 4,
                      prompt: str = VIDEO_CAPTION_PROMPT,
                      prompt_suffix: str = VQA_PROMPT_SUFFIX
                      ) -> Iterator[Dict[str, Any]]:
    """Video caption / QA eval (:389-528): yields {"question", "answer",
    "frames" [T, H, W, 3], "sample_id"}. QA records (with a "question")
    get the one-word suffix, caption records the video caption prompt."""
    for i, rec in enumerate(iter_json_records(ann_path)):
        frames = load_video_frames(os.path.join(video_root, rec["video"]),
                                   num_frames, image_size)
        if frames is None:
            continue
        if "question" in rec:
            q = str(rec["question"])
            if not q.endswith("?"):
                q += "?"
            question = q + prompt_suffix
            answer = rec.get("answer", "")
        else:
            question = prompt
            answer = rec.get("caption", "")
        if isinstance(answer, list):
            answer = answer[0] if answer else ""
        yield {"question": question, "answer": str(answer), "frames": frames,
               "sample_id": rec.get("sample_id", i)}


def batch_eval_stream(stream: Iterable[Dict[str, Any]], batch_size: int
                      ) -> Iterator[List[Dict[str, Any]]]:
    buf: List[Dict[str, Any]] = []
    for rec in stream:
        buf.append(rec)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def evaluate_vqa(
    generate_fn: Callable[[List[Dict[str, Any]]], List[str]],
    eval_stream: Iterable[Dict[str, Any]],
    batch_size: int = 16,
    max_batches: Optional[int] = None,
) -> Dict[str, float]:
    """VQA eval loop (eval/eval_vqa.py): ``generate_fn`` maps a batch of
    reader records to answer strings; scored by ``vqa_accuracy`` against
    each record's own answers."""
    from .caption_eval import dedupe_by_key, gather_results
    from .metrics import vqa_accuracy
    local: List[Dict] = []
    annotations: Dict[Any, List[str]] = {}
    for i, batch in enumerate(batch_eval_stream(eval_stream, batch_size)):
        if max_batches is not None and i >= max_batches:
            break
        answers = generate_fn(batch)
        for rec, ans in zip(batch, answers):
            qid = rec.get("question_id", rec.get("sample_id"))
            local.append({"question_id": qid, "answer": ans})
            gts = rec.get("answers") or [rec["answer"]]
            # VQA accuracy divides the matches by 3: a single annotator's
            # answer is replicated so an exact match scores 1.0; VQAv2's
            # lists of ten pass through
            annotations[qid] = gts if len(gts) >= 3 else gts * 3
    results = dedupe_by_key(gather_results(local), key="question_id")
    return vqa_accuracy(results, annotations)
