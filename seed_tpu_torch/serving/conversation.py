"""Multi-turn conversation state for the chat frontend (counterpart of
seed_tpu/serving/conversation.py).

Rebuild of gradio_demo/conversation.py: the Conversation dataclass keeps
per-turn text + images (as paths/base64 or cached 32-id lists), renders the
/generate request for the two template families the reference ships
(SINGLE ``USER:/ASSISTANT:`` with '\\n' separator and LLAMA_2 ``[INST]``,
conversation.py:51-95 + :162-190), and back-fills image-id caches from
responses (update_image_ids) so an image is encoded only once in a conversation.
"""
from __future__ import annotations

import copy
import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence

from .. import IMG_FLAG


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    LLAMA_2 = enum.auto()


@dataclasses.dataclass
class Message:
    role: str
    text: str                                   # contains IMG_FLAG per image
    images: List[Any] = dataclasses.field(default_factory=list)
    images_ids: List[Optional[List[int]]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class Conversation:
    system: str = ""
    roles: Sequence[str] = ("USER", "ASSISTANT")
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "\n"
    messages: List[Message] = dataclasses.field(default_factory=list)

    def append(self, role: str, text: str, images: Optional[List[Any]] = None):
        images = images or []
        assert text.count(IMG_FLAG) == len(images), \
            f"text has {text.count(IMG_FLAG)} {IMG_FLAG}, got {len(images)} images"
        self.messages.append(Message(role, text, list(images),
                                     [None] * len(images)))

    def get_prompt(self) -> Dict[str, Any]:
        """-> the /generate request body {'text': ..., 'images': [...]}."""
        images: List[Any] = []
        if self.sep_style == SeparatorStyle.SINGLE:
            text = (self.system + self.sep) if self.system else ""
            for m in self.messages:
                text += f"{m.role}: {m.text}{self.sep}"
                images.extend(ids if ids is not None else img
                              for img, ids in zip(m.images, m.images_ids))
            text += f"{self.roles[1]}:"
        elif self.sep_style == SeparatorStyle.LLAMA_2:
            text = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" if self.system else ""
            for i, m in enumerate(self.messages):
                if i % 2 == 0:
                    text += f"[INST] {m.text} [/INST]{self.sep}"
                else:
                    text += m.text + self.sep
                images.extend(ids if ids is not None else img
                              for img, ids in zip(m.images, m.images_ids))
        else:
            raise NotImplementedError(self.sep_style)
        return {"text": text, "images": images}

    def update_image_ids(self, images_ids: List[List[int]]) -> None:
        """Back-fill server-returned id caches in message order (:100-115)."""
        i = 0
        for m in self.messages:
            for j in range(len(m.images_ids)):
                if i < len(images_ids) and images_ids[i]:
                    m.images_ids[j] = list(images_ids[i])
                i += 1

    def add_response(self, resp: Dict[str, Any]) -> None:
        """Append the assistant reply from a /generate response."""
        text = resp.get("text", "")
        images = resp.get("images", [])
        n = text.count(IMG_FLAG)
        images = (images + [""] * n)[:n]
        msg = Message(self.roles[1], text, images, [None] * n)
        # generated images come back with their ids at the tail of images_ids
        gen_ids = resp.get("images_ids", [])[-n:] if n else []
        for j, ids in enumerate(gen_ids):
            if ids:
                msg.images_ids[j] = list(ids)
        self.messages.append(msg)

    def copy(self) -> "Conversation":
        return copy.deepcopy(self)


CONV_SEED_LLAMA = Conversation(system="", roles=("USER", "ASSISTANT"),
                               sep_style=SeparatorStyle.SINGLE, sep="\n")
CONV_LLAMA_2 = Conversation(system="", roles=("[INST]", "[/INST]"),
                            sep_style=SeparatorStyle.LLAMA_2, sep="\n")
