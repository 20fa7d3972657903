"""Eval data readers (counterpart of seed_tpu/eval/eval_readers.py): the
json / jsonl record reader the training entry points' eval rounds use. The
caption, VQA, edit and video streams come with the rest of ``eval/``."""
from __future__ import annotations

import json
from typing import Any, Dict, Iterator


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
