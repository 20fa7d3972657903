"""Sequence builders: pre-tokenized records -> training examples
(counterpart of seed_tpu/data/builders.py).

The reference builds sequences in string space (image ids formatted as
``<img_00042>`` and re-tokenized); these build them in id space: image code k
is id 32000 + k (IMAGE_ID_SHIFT), with no string round trip. Semantics kept:

- caption pairs: bos + [caption][image] or [image][caption] at
  ``reverse_ratio`` (t2i vs i2t) + eos; ``mask_left_label`` puts -100 on
  the conditioning prefix through BOI / EOI;
- SFT conversations: per turn ``USER: <img>q\nASSISTANT: a``; -100 on the
  question spans; bos / eos; padded to max_length with -100 labels;
- batches collate to numpy {input_ids, attention_mask, labels} int32.

The builders draw from ``rng`` (a ``random.Random``) with the same calls in
the same order as seed_tpu's, so one seed gives the same examples.
"""
from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import BOI_TOKEN_ID, EOI_TOKEN_ID, IMAGE_ID_SHIFT

IGNORE_INDEX = -100


def clean_caption(caption: str, max_words: int = 50) -> str:
    """Caption cleanup (blip_caption, blip_processors.py:28-69): lowercase,
    strip odd punctuation, collapse whitespace, truncate words."""
    import re as _re
    cap = _re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
    cap = _re.sub(r"\s{2,}", " ", cap).rstrip("\n").strip(" ")
    words = cap.split(" ")
    if len(words) > max_words:
        cap = " ".join(words[:max_words])
    return cap


def image_token_ids(image_ids: Sequence[int]) -> List[int]:
    return ([BOI_TOKEN_ID] + [int(i) + IMAGE_ID_SHIFT for i in image_ids]
            + [EOI_TOKEN_ID])


def _pad(ids: List[int], mask: List[int], labels: List[int], max_length: int,
         pad_id: int = 0):
    ids, mask, labels = ids[:max_length], mask[:max_length], labels[:max_length]
    n = max_length - len(ids)
    return (ids + [pad_id] * n, mask + [0] * n, labels + [IGNORE_INDEX] * n)


def build_caption_example(
    record: Dict[str, Any],
    text_tokenizer,
    max_length: int = 128,
    reverse_ratio: float = 0.5,
    mask_left_label: bool = False,
    caption_prompts: Optional[Sequence[str]] = None,
    rng: Optional[random.Random] = None,
) -> Optional[Dict[str, np.ndarray]]:
    rng = rng or random
    text = record.get("text", "")
    if not str(text).strip(" ;,[]{}'\".?:"):
        return None  # empty-caption filter (torchdata_train.py:131-133)
    if caption_prompts:
        text = rng.choice(list(caption_prompts)).format(text)

    img = image_token_ids(record["image_ids"])
    txt = text_tokenizer.encode(text)
    reverse = rng.random() < reverse_ratio
    body = (img + txt) if reverse else (txt + img)
    ids = [text_tokenizer.bos_token_id] + body + [text_tokenizer.eos_token_id]
    mask = [1] * len(ids)
    labels = list(ids)

    if mask_left_label:
        # mask conditioning prefix: through EOI (i2t) or through BOI (t2i)
        anchor = EOI_TOKEN_ID if reverse else BOI_TOKEN_ID
        idx = ids.index(anchor)
        labels[:idx + 1] = [IGNORE_INDEX] * (idx + 1)

    ids, mask, labels = _pad(ids, mask, labels, max_length)
    return {"input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "labels": np.asarray(labels, np.int32)}


def build_conversation_example(
    turns: Sequence[Dict[str, Any]],
    text_tokenizer,
    max_length: int = 1024,
    s_token: str = "USER:",
    e_token: str = "ASSISTANT:",
    sep: str = "\n",
) -> Dict[str, np.ndarray]:
    """turns: [{"question": str, "answer": str, "image_ids": optional}].

    First turn carries the image tokens before the question
    (torchdata_sft.py:490-494); question spans are -100.
    """
    ids: List[int] = []
    labels: List[int] = []
    for i, turn in enumerate(turns):
        q_ids: List[int] = []
        prefix = (s_token + " ") if i == 0 else (sep + s_token + " ")
        q_ids.extend(text_tokenizer.encode(prefix))
        if i == 0 and turn.get("image_ids") is not None:
            q_ids.extend(image_token_ids(turn["image_ids"]))
        q_ids.extend(text_tokenizer.encode(str(turn["question"]) + sep + e_token))
        a = str(turn["answer"])
        if not a.endswith("."):
            a = a + "."
        a_ids = text_tokenizer.encode(a)
        ids.extend(q_ids + a_ids)
        labels.extend([IGNORE_INDEX] * len(q_ids) + a_ids)

    ids = [text_tokenizer.bos_token_id] + ids + [text_tokenizer.eos_token_id]
    labels = [IGNORE_INDEX] + labels + [text_tokenizer.eos_token_id]
    mask = [1] * len(ids)
    ids, mask, labels = _pad(ids, mask, labels, max_length)
    return {"input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "labels": np.asarray(labels, np.int32)}


def build_interleaved_example(
    record: Dict[str, Any],
    text_tokenizer,
    max_length: int = 1024,
    reverse_ratio: float = 0.5,
    max_images: Optional[int] = None,
    rng: Optional[random.Random] = None,
) -> Optional[Dict[str, np.ndarray]]:
    """MMC4-style interleaved documents (torchdata_train.py:473-537):
    record = {"image_ids": [codes | None, ...], "texts": [None | str, ...]}
    with image-first swapping at ``reverse_ratio`` and a ``max_images`` cap.
    """
    rng = rng or random
    image_list = list(record["image_ids"])
    text_list = list(record["texts"])
    if rng.random() < reverse_ratio:
        # swap each (text, image) pair so images come first (:488-496)
        idx = 0
        while idx < len(image_list) - 1:
            if image_list[idx] is not None:
                image_list[idx], image_list[idx + 1] = \
                    image_list[idx + 1], image_list[idx]
                text_list[idx], text_list[idx + 1] = \
                    text_list[idx + 1], text_list[idx]
                idx += 2
            else:
                idx += 1

    ids: List[int] = [text_tokenizer.bos_token_id]
    n_img = 0
    for img, txt in zip(image_list, text_list):
        if (img is None) == (txt is None):
            return None  # malformed record: exactly one must be set (:501)
        if img is not None:
            if max_images is not None and n_img >= max_images:
                break
            ids.extend(image_token_ids(img))
            n_img += 1
        else:
            ids.extend(text_tokenizer.encode(txt))
            if max_images is not None and n_img >= max_images:
                break
    ids.append(text_tokenizer.eos_token_id)
    mask = [1] * len(ids)
    labels = list(ids)
    ids, mask, labels = _pad(ids, mask, labels, max_length)
    return {"input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "labels": np.asarray(labels, np.int32)}


def match_interleaved_images(
    record: Dict[str, Any],
    *,
    sim_threshold: float = 0.24,
    min_kb: int = 10,
    max_images: int = 5,
    single_image_keep: float = 0.5,
    rng: Optional[random.Random] = None,
) -> Optional[Dict[str, List]]:
    """Raw-MMC4 CLIP-similarity matching (OpenFlamingo path,
    MultiModalLLM/src/data/data.py:265-334): each document carries
    ``text_list`` plus ``image_info`` with per-image CLIP ``matched_sim``
    and ``matched_text_index``. Filters (>= min_kb bytes, sim >= threshold,
    cap at ``max_images``), inserts each surviving image immediately before
    its matched sentence, drops image-free docs and (at 50%) single-image
    docs.

    record = {"text_list": [str, ...],
              "image_info": [{"image_base64" | "image_bytes" | "image",
                              "matched_text_index": int,
                              "matched_sim": float}, ...]}
    Returns interleaved parallel lists {"images": [...], "texts": [...]}
    (exactly one of images[i]/texts[i] set — the build_interleaved_example
    contract once images are tokenized to ids), or None when rejected.
    """
    import base64
    import io

    rng = rng or random
    sentences = list(record["text_list"])
    matched: List[tuple] = []
    for info in record.get("image_info", []):
        raw = None
        if "image_base64" in info:
            raw = base64.b64decode(info["image_base64"])
        elif "image_bytes" in info:
            raw = info["image_bytes"]
        if raw is not None:
            if len(raw) // 1000 <= min_kb:      # >=10KB filter (:276-277)
                continue
        if float(info.get("matched_sim", 1.0)) < sim_threshold:  # (:279)
            continue
        if raw is not None:
            from PIL import Image
            img = Image.open(io.BytesIO(raw))
            if img.mode == "P" and "transparency" in img.info:  # (:286-291)
                try:
                    img = img.convert("RGBA")
                except ValueError:
                    pass
            img = np.asarray(img.convert("RGB"))
        else:
            img = np.asarray(info["image"])
        matched.append((int(info["matched_text_index"]), img))
        if len(matched) >= max_images:          # cap at 5 (:299-301)
            break
    if not matched:
        return None                             # no images (:294-295)
    if len(matched) == 1 and rng.random() > single_image_keep:
        return None                             # 50% single-image drop (:328)

    by_sentence: Dict[int, List[np.ndarray]] = {}
    for ix, img in matched:
        by_sentence.setdefault(ix, []).append(img)
    images: List = []
    texts: List = []
    for ix, sent in enumerate(sentences):
        for img in by_sentence.get(ix, []):     # image before sentence (:310)
            images.append(img)
            texts.append(None)
        images.append(None)
        texts.append(sent)
    return {"images": images, "texts": texts}


def build_video_example(
    record: Dict[str, Any],
    text_tokenizer,
    max_length: int = 256,
    image_id_length: int = 32,
    num_frames: int = 4,
) -> Optional[Dict[str, np.ndarray]]:
    """Video captioning (torchdata_train.py:1047-1106): ``num_frames``
    consecutive 32-id frames, each in its own BOI/EOI block, caption
    supervised, frames masked."""
    if "image_ids" not in record or "answer" not in record:
        return None
    flat = record["image_ids"]
    if flat and isinstance(flat[0], (list, np.ndarray)):
        frames = [list(f) for f in flat]
    else:
        frames = [flat[i * image_id_length:(i + 1) * image_id_length]
                  for i in range(num_frames)]
    ids: List[int] = []
    labels: List[int] = []
    for f in frames:
        seg = image_token_ids(f)
        ids.extend(seg)
        labels.extend([IGNORE_INDEX] * len(seg))
    cap = text_tokenizer.encode(str(record["answer"]))
    ids.extend(cap)
    labels.extend(cap)
    ids = [text_tokenizer.bos_token_id] + ids + [text_tokenizer.eos_token_id]
    labels = [IGNORE_INDEX] + labels + [text_tokenizer.eos_token_id]
    mask = [1] * len(ids)
    ids, mask, labels = _pad(ids, mask, labels, max_length)
    return {"input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "labels": np.asarray(labels, np.int32)}


def build_edit_example(
    record: Dict[str, Any],
    text_tokenizer,
    max_length: int = 256,
) -> Optional[Dict[str, np.ndarray]]:
    """Image editing (torchdata_sft.py:292 source -> instruction -> target):
    supervise only the target image tokens."""
    src = record.get("source_image_ids")
    tgt = record.get("target_image_ids")
    instr = record.get("instruction", record.get("text", ""))
    if src is None or tgt is None:
        return None
    prefix = image_token_ids(src) + text_tokenizer.encode(str(instr))
    target = image_token_ids(tgt)
    ids = [text_tokenizer.bos_token_id] + prefix + target \
        + [text_tokenizer.eos_token_id]
    labels = ([IGNORE_INDEX] * (1 + len(prefix)) + target
              + [text_tokenizer.eos_token_id])
    mask = [1] * len(ids)
    ids, mask, labels = _pad(ids, mask, labels, max_length)
    return {"input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "labels": np.asarray(labels, np.int32)}


def build_story_example(
    record: Dict[str, Any],
    text_tokenizer,
    max_length: int = 1024,
) -> Optional[Dict[str, np.ndarray]]:
    """Visual storytelling (VIST, torchdata_sft.py:681): alternating
    sentence/image sequence, everything after the first image supervised."""
    steps = record.get("story")  # [{"text": str, "image_ids": [...]}, ...]
    if not steps:
        return None
    ids: List[int] = []
    labels: List[int] = []
    for i, step in enumerate(steps):
        t = text_tokenizer.encode(str(step.get("text", "")))
        seg = t + (image_token_ids(step["image_ids"])
                   if step.get("image_ids") is not None else [])
        ids.extend(seg)
        # first frame is context; the continuation is supervised
        labels.extend(([IGNORE_INDEX] * len(seg)) if i == 0 else seg)
    ids = [text_tokenizer.bos_token_id] + ids + [text_tokenizer.eos_token_id]
    labels = [IGNORE_INDEX] + labels + [text_tokenizer.eos_token_id]
    mask = [1] * len(ids)
    ids, mask, labels = _pad(ids, mask, labels, max_length)
    return {"input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "labels": np.asarray(labels, np.int32)}


def build_multi_image_qa_example(
    record: Dict[str, Any],
    text_tokenizer,
    max_length: int = 512,
    s_token: str = "USER:",
    e_token: str = "ASSISTANT:",
    sep: str = "\n",
) -> Optional[Dict[str, np.ndarray]]:
    """Multi-image QA (MIMIC-IT CGD spot-the-difference, torchdata_sft.py:612):
    N images in the question prefix, answer supervised."""
    images = record.get("images_ids") or record.get("image_ids_list")
    if not images:
        return None
    q_ids = text_tokenizer.encode(s_token + " ")
    for codes in images:
        q_ids.extend(image_token_ids(codes))
    q_ids.extend(text_tokenizer.encode(
        str(record.get("question", "")) + sep + e_token))
    a = str(record.get("answer", ""))
    a_ids = text_tokenizer.encode(a if a.endswith(".") else a + ".")
    ids = [text_tokenizer.bos_token_id] + q_ids + a_ids \
        + [text_tokenizer.eos_token_id]
    labels = ([IGNORE_INDEX] * (1 + len(q_ids)) + a_ids
              + [text_tokenizer.eos_token_id])
    mask = [1] * len(ids)
    ids, mask, labels = _pad(ids, mask, labels, max_length)
    return {"input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "labels": np.asarray(labels, np.int32)}


def build_retrieval_augmented_example(
    record: Dict[str, Any],
    text_tokenizer,
    max_length: int = 256,
    num_retrieved: int = 2,
    rng: Optional[random.Random] = None,
) -> Optional[Dict[str, np.ndarray]]:
    """Retrieval-augmented caption->image (torchdata_train.py:600-697):
    retrieved neighbor captions prefix the target caption; only the target
    image tokens are supervised."""
    rng = rng or random
    retrieved = list(record.get("retrieved_texts", []))[:num_retrieved]
    text = record.get("text", "")
    if not str(text).strip():
        return None
    prefix_ids: List[int] = []
    for r in retrieved:
        prefix_ids.extend(text_tokenizer.encode(str(r) + " "))
    prefix_ids.extend(text_tokenizer.encode(str(text)))
    target = image_token_ids(record["image_ids"])
    ids = [text_tokenizer.bos_token_id] + prefix_ids + target \
        + [text_tokenizer.eos_token_id]
    labels = ([IGNORE_INDEX] * (1 + len(prefix_ids)) + target
              + [text_tokenizer.eos_token_id])
    mask = [1] * len(ids)
    ids, mask, labels = _pad(ids, mask, labels, max_length)
    return {"input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "labels": np.asarray(labels, np.int32)}


def _finish(ids: List[int], labels: List[int], text_tokenizer,
            max_length: int) -> Dict[str, np.ndarray]:
    """bos/eos framing + padding shared by the multi-turn builders."""
    ids = [text_tokenizer.bos_token_id] + ids + [text_tokenizer.eos_token_id]
    labels = [IGNORE_INDEX] + labels + [text_tokenizer.eos_token_id]
    mask = [1] * len(ids)
    ids, mask, labels = _pad(ids, mask, labels, max_length)
    return {"input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "labels": np.asarray(labels, np.int32)}


def build_text_conversation_example(
    record: Dict[str, Any],
    text_tokenizer,
    max_length: int = 512,
    system_message: str = "",
    s_token: str = "USER:",
    e_token: str = "ASSISTANT:",
    sep: str = "\n",
) -> Optional[Dict[str, np.ndarray]]:
    """Text-only multi-turn conversation (ShareGPT-style,
    decode_text_conversation_data_for_llm, torchdata_sft.py:111-180):
    record = {"data": [user, assistant, user, assistant, ...]};
    user turns -100, assistant turns supervised."""
    data = record.get("data")
    if not data:
        return None
    ids: List[int] = []
    labels: List[int] = []
    if system_message:
        if not system_message.endswith("\n"):
            system_message += "\n"
        s_ids = text_tokenizer.encode(system_message)
        ids.extend(s_ids)
        labels.extend([IGNORE_INDEX] * len(s_ids))
    for idx, content in enumerate(data):
        if idx % 2 == 0:  # user
            prefix = (s_token + " ") if idx == 0 else (sep + s_token + " ")
            t_ids = text_tokenizer.encode(prefix + str(content) + sep + e_token)
            ids.extend(t_ids)
            labels.extend([IGNORE_INDEX] * len(t_ids))
        else:             # assistant
            t_ids = text_tokenizer.encode(str(content))
            ids.extend(t_ids)
            labels.extend(t_ids)
    return _finish(ids, labels, text_tokenizer, max_length)


def build_visual_instruction_example(
    record: Dict[str, Any],
    text_tokenizer,
    max_length: int = 512,
    s_token: str = "USER:",
    e_token: str = "ASSISTANT:",
    sep: str = "\n",
) -> Optional[Dict[str, np.ndarray]]:
    """LLaVA/M3IT-style visual instruction
    (decode_visual_question_data_for_llm, torchdata_sft.py:182-290): all
    images prefix the FIRST user turn; two record formats —
    {"image_ids": [codes,...], "data": [u, a, ...]} multi-turn, or
    {"image_ids": ..., "instruction", "inputs", "outputs"} single-turn
    (empty inputs falls back to the instruction, :241-243)."""
    images = record.get("image_ids")
    if images is None:
        return None
    if images and not isinstance(images[0], (list, np.ndarray)):
        images = [images]
    img_ids: List[int] = []
    for codes in images:
        img_ids.extend(image_token_ids(codes))

    ids: List[int] = []
    labels: List[int] = []
    if record.get("data"):
        for idx, content in enumerate(record["data"]):
            content = str(content).strip()
            if idx % 2 == 0:
                head = text_tokenizer.encode(
                    (s_token + " ") if idx == 0 else (sep + s_token + " "))
                body = (img_ids if idx == 0 else [])
                tail = text_tokenizer.encode(content + sep + e_token)
                t_ids = head + body + tail
                ids.extend(t_ids)
                labels.extend([IGNORE_INDEX] * len(t_ids))
            else:
                if not content.endswith("."):
                    content += "."
                t_ids = text_tokenizer.encode(content)
                ids.extend(t_ids)
                labels.extend(t_ids)
    elif "instruction" in record:
        inputs = str(record.get("inputs", "")).strip() or str(record["instruction"])
        q_ids = (text_tokenizer.encode(s_token + " ") + img_ids
                 + text_tokenizer.encode(inputs + sep + e_token))
        a_ids = text_tokenizer.encode(str(record.get("outputs", "")))
        ids.extend(q_ids + a_ids)
        labels.extend([IGNORE_INDEX] * len(q_ids) + a_ids)
    else:
        return None
    return _finish(ids, labels, text_tokenizer, max_length)


# assistant-side response openers for edit turns (torchdata_sft.py:71-79)
EDIT_PROMPT_RESPONSES = [
    "Here is a picture.",
    "I have created an image.",
    "Enjoy this picture.",
    "I have generated an image.",
    "Here's a picture.",
    "Here's an image.",
    "Certainly, here's an image.",
    "Sure, here is a picture.",
]


def build_multi_edit_example(
    record: Dict[str, Any],
    text_tokenizer,
    max_length: int = 512,
    image_id_length: int = 32,
    s_token: str = "USER:",
    e_token: str = "ASSISTANT:",
    sep: str = "\n",
    rng: Optional[random.Random] = None,
) -> Optional[Dict[str, np.ndarray]]:
    """Multi-turn image editing (MagicBrush-style,
    decode_edit_multi_pair_for_llm, torchdata_sft.py:360-451): image_ids
    holds N+1 concatenated 32-id frames; turn i asks instruction{i} on the
    previous frame and answers with a response opener + the next frame."""
    rng = rng or random
    flat = record.get("image_ids")
    if flat is None:
        return None
    frames = [list(flat[i * image_id_length:(i + 1) * image_id_length])
              for i in range(len(flat) // image_id_length)]
    instrs = []
    i = 0
    while f"instruction{i}" in record:
        instrs.append(str(record[f"instruction{i}"]))
        i += 1
    if len(frames) < 2 or len(instrs) < len(frames) - 1:
        return None
    response = rng.choice(EDIT_PROMPT_RESPONSES)
    ids: List[int] = []
    labels: List[int] = []
    for t in range(len(frames) - 1):
        if t == 0:
            q_ids = (text_tokenizer.encode(s_token + " ")
                     + image_token_ids(frames[0])
                     + text_tokenizer.encode(instrs[0] + sep + e_token))
        else:
            q_ids = text_tokenizer.encode(
                sep + s_token + " " + instrs[t] + sep + e_token)
        a_ids = (text_tokenizer.encode(response)
                 + image_token_ids(frames[t + 1]))
        ids.extend(q_ids + a_ids)
        labels.extend([IGNORE_INDEX] * len(q_ids) + a_ids)
    return _finish(ids, labels, text_tokenizer, max_length)


def build_video_conversation_example(
    record: Dict[str, Any],
    text_tokenizer,
    max_length: int = 512,
    image_id_length: int = 32,
    s_token: str = "USER:",
    e_token: str = "ASSISTANT:",
    sep: str = "\n",
) -> Optional[Dict[str, np.ndarray]]:
    """Video QA conversation (decode_video_conversation_pair_for_llm,
    torchdata_sft.py:530-610): frames prefix the first question; multi-QA
    records pack turns as 'Question: ...'/'Answer: ...' strings."""
    flat = record.get("image_ids")
    question = str(record.get("question", ""))
    answer = str(record.get("answer", ""))
    if flat is None or not question:
        return None
    n_frames = len(flat) // image_id_length
    img_ids: List[int] = []
    for i in range(n_frames):
        img_ids.extend(image_token_ids(
            flat[i * image_id_length:(i + 1) * image_id_length]))

    if "Question:" in question and "Answer:" in answer:
        q_list = [q.strip() for q in question.split("Question: ")[1:]]
        a_list = [a.strip() for a in answer.split("Answer: ")[1:]]
        if len(q_list) != len(a_list):
            return None
        turns = list(zip(q_list, a_list))
    else:
        turns = [(question, answer)]

    ids: List[int] = []
    labels: List[int] = []
    for i, (q, a) in enumerate(turns):
        if i == 0:
            q_ids = (text_tokenizer.encode(s_token + " ") + img_ids
                     + text_tokenizer.encode(q + sep + e_token))
        else:
            q_ids = text_tokenizer.encode(sep + s_token + " " + q + sep + e_token)
        a_ids = text_tokenizer.encode(a)
        ids.extend(q_ids + a_ids)
        labels.extend([IGNORE_INDEX] * len(q_ids) + a_ids)
    return _finish(ids, labels, text_tokenizer, max_length)


# the 20 t2i generation prompt templates (torchdata_sft.py:17-37 gen_prompt;
# used by build_caption_example(caption_prompts=...))
GENERATION_PROMPTS = [
    "Please show me a picture of {}",
    "Please design an image of {}",
    "Please produce a photo of {}",
    "Please generate an image of {}",
    "Please draw a painting of {}",
    "I'd like to see a drawing of {}",
    "I'd love to see an illustration of {}",
    "I'd like to view an image of {}",
    "I want to see a picture of {}",
    "I would like to see a photo of {}",
    "Show me a photo of {}",
    "Generate a picture of {}",
    "Show me a photograph of {}",
    "Generate an image of {}",
    "Can you make an image of {}",
    "Can you draw a painting of {}",
    "Can you produce a picture of {}",
    "Can you generate a photo of {}",
    "Can you depict a picture of {}",
    "Can you show me an illustration of {}",
]


def collate(examples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = examples[0].keys()
    return {k: np.stack([e[k] for e in examples], 0) for k in keys}
