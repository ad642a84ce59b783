"""Conversation templates.

Pinned to /root/reference/dexbotic/tokenization/conversation.py:187-233:
'dexbotic' (USER/ASSISTANT, sep2=<|endoftext|>), 'step' (sep2=<|im_end|>),
'llama_3' (header-id style).
"""

from __future__ import annotations

import dataclasses
import enum


class SeparatorStyle(enum.Enum):
    TWO = "two"
    LLAMA_3 = "llama_3"


@dataclasses.dataclass
class Conversation:
    system: str
    roles: tuple[str, str]
    version: str
    sep_style: SeparatorStyle
    sep: str
    sep2: str
    messages: list = dataclasses.field(default_factory=list)

    def copy(self) -> "Conversation":
        return dataclasses.replace(self, messages=list(self.messages))

    def append_message(self, role: str, message: str | None):
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            out = self.system + seps[0]
            for i, (role, msg) in enumerate(self.messages):
                if msg:
                    out += role + ": " + msg + seps[i % 2]
                else:
                    out += role + ":"
            return out
        if self.sep_style == SeparatorStyle.LLAMA_3:
            out = self.system + self.sep
            for rid, (role, msg) in enumerate(self.messages):
                if msg:
                    # the LAST message closes with sep2 (<|end_of_text|>),
                    # earlier ones with sep (conversation.py:95-105)
                    sep = self.sep if rid < len(self.messages) - 1 else self.sep2
                    out += role + msg + sep
                else:
                    out += role
            return out
        raise ValueError(self.sep_style)


conv_dexbotic = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    version="dexbotic",
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="<|endoftext|>",
)

conv_step = dataclasses.replace(conv_dexbotic, version="step", sep2="<|im_end|>")

llama_3_chat = Conversation(
    system="<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
    "You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language.",
    roles=(
        "<|start_header_id|>user<|end_header_id|>\n\n",
        "<|start_header_id|>assistant<|end_header_id|>\n\n",
    ),
    version="llama_v3",
    sep_style=SeparatorStyle.LLAMA_3,
    sep="<|eot_id|>",
    sep2="<|end_of_text|>",
)

conv_templates = {
    "dexbotic": conv_dexbotic,
    "step": conv_step,
    "llama_3": llama_3_chat,
}


class KeywordsStoppingCriteria:
    """Stop AR generation when any keyword id-sequence appears at the end
    (conversation.py:15-49 behavior, host-side)."""

    def __init__(self, keywords: list[str], tokenizer, input_len: int):
        self.keyword_ids = []
        for kw in keywords:
            ids = tokenizer.encode(kw)
            if len(ids) > 1 and ids[0] == getattr(tokenizer, "bos_token_id", None):
                ids = ids[1:]
            self.keyword_ids.append(ids)
        self.tokenizer = tokenizer
        self.keywords = keywords
        self.input_len = input_len

    def should_stop(self, output_ids: list[int]) -> bool:
        gen = output_ids[self.input_len :]
        for ids in self.keyword_ids:
            if len(gen) >= len(ids) and gen[-len(ids) :] == ids:
                return True
        text = self.tokenizer.decode(gen)
        return any(kw in text for kw in self.keywords)
