"""Tokenization: image-token splicing + supervised-target masking.

Works with any HF-style tokenizer object exposing ``__call__/encode/decode``,
``bos_token_id``, ``eos_token_id``, ``pad_token_id``, ``model_max_length``.
A self-contained byte-level ``SimpleTokenizer`` is provided for tests and
offline use (no hub access in this environment).

Key TPU-first difference from the reference
(/root/reference/dexbotic/tokenization/tokenization.py): ``<image>`` expands
to ``num_image_tokens`` IMAGE_TOKEN_INDEX placeholders at tokenize time, so
the model-side splice is a static-shape select (models/vlm.py) instead of
ragged insert-and-repad.  Set num_image_tokens=1 to reproduce the
reference's raw id streams exactly.
"""

from __future__ import annotations

import numpy as np

from dexbotic_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from dexbotic_tpu_torch.tokenization import conversation as conversation_lib


class SimpleTokenizer:
    """Byte-level tokenizer with special tokens; offset-maps bytes by +N."""

    SPECIALS = ["<pad>", "<s>", "</s>", "<|endoftext|>", "<|im_end|>", "<unk>"]

    def __init__(self, model_max_length: int = 2048, extra_specials: list[str] | None = None):
        self.specials = list(self.SPECIALS) + list(extra_specials or [])
        self.offset = len(self.specials)
        self.model_max_length = model_max_length
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 3  # <|endoftext|> doubles as eos (dexbotic template)
        self._special_ids = {s: i for i, s in enumerate(self.specials)}

    @property
    def vocab_size(self) -> int:
        return self.offset + 256

    def add_special_tokens(self, tokens: list[str]) -> int:
        added = 0
        for t in tokens:
            if t not in self._special_ids:
                # appended AFTER byte range so existing ids stay stable
                self._special_ids[t] = self.vocab_size
                self.specials.append(t)
                added += 1
        return added

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [self.bos_token_id] if add_bos else []
        i = 0
        while i < len(text):
            matched = None
            for s, sid in self._special_ids.items():
                if text.startswith(s, i):
                    matched = (s, sid)
                    break
            if matched:
                ids.append(matched[1])
                i += len(matched[0])
            else:
                for b in text[i].encode("utf-8"):
                    ids.append(self.offset + b if self.offset + b < self.vocab_size else self._special_ids["<unk>"])
                i += 1
        return ids

    def __call__(self, text, **kw):
        if isinstance(text, str):
            return type("Enc", (), {"input_ids": self.encode(text)})()
        return type("Enc", (), {"input_ids": [self.encode(t) for t in text]})()

    def batch_decode(self, seqs, **kw) -> list[str]:
        return [self.decode(s) for s in seqs]

    def decode(self, ids, **kw) -> str:
        out = []
        byte_buf = []
        inv = {v: k for k, v in self._special_ids.items()}

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if i < 0:
                continue
            if i in inv and (i < self.offset or i >= self.offset + 256):
                flush()
                if i not in (self.bos_token_id,):
                    out.append(inv[i])
            elif self.offset <= i < self.offset + 256:
                byte_buf.append(i - self.offset)
        flush()
        return "".join(out)


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    num_image_tokens: int = 1,
) -> list[int]:
    """Tokenize text around '<image>' tags, splicing placeholder ids.

    With num_image_tokens=1 this is bit-identical to the reference
    (tokenization.py:10-31); larger values pre-expand for static shapes.
    """
    chunks = [tokenizer(c).input_ids for c in prompt.split("<image>")]

    ids: list[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == getattr(tokenizer, "bos_token_id", None):
        offset = 1
        ids.append(chunks[0][0])
    # chunk[offset:] drops each chunk's leading bos (the tokenizer re-adds it
    # per split piece); a single bos was re-inserted above.
    sep = [image_token_index] * num_image_tokens
    for i, chunk in enumerate(chunks):
        if i > 0:
            ids.extend(sep)
        ids.extend(chunk[offset:])
    return ids


def tokenize_dexbotic(
    sources: list,
    tokenizer,
    has_image: bool = False,
    chat_template: str = "dexbotic",
    num_image_tokens: int = 1,
) -> dict:
    """Conversations -> (input_ids, labels) with instruction spans masked.

    Reproduces tokenize_dexbotic (tokenization.py:34-120): TWO-separator
    rounds, per-round instruction masking, mismatch guard that masks
    everything and warns.
    """
    conv = conversation_lib.conv_templates[chat_template].copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}

    conversations = []
    for source in sources:
        if isinstance(source, dict):
            source = [source]
        if roles.get(source[0].get("from")) != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2]
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())

    def tok(text):
        if has_image:
            return tokenizer_image_token(text, tokenizer, num_image_tokens=num_image_tokens)
        return tokenizer(text).input_ids

    input_ids = [tok(c) for c in conversations]
    max_len = tokenizer.model_max_length
    input_ids = [ids[:max_len] for ids in input_ids]
    targets = [list(ids) for ids in input_ids]

    assert conv.sep_style == conversation_lib.SeparatorStyle.TWO
    sep = conv.sep + conv.roles[1] + ": "
    pad_id = tokenizer.pad_token_id
    eos_is_pad = pad_id == tokenizer.eos_token_id

    for conversation, target, ids in zip(conversations, targets, input_ids):
        total_len = sum(1 for t in ids if t != pad_id)
        rounds = conversation.split(conv.sep2)
        cur_len = 0
        end_cnt = 0
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(tok(rou)) + 1  # + sep2-as-eos token
            instruction_len = len(tok(parts[0])) - 1
            end_cnt += 1
            for i in range(cur_len, min(cur_len + instruction_len, len(target))):
                target[i] = IGNORE_INDEX
            cur_len += round_len
        for i in range(cur_len, len(target)):
            target[i] = IGNORE_INDEX
        if eos_is_pad:
            cur_len -= end_cnt
        if cur_len < max_len and cur_len != total_len:
            for i in range(len(target)):
                target[i] = IGNORE_INDEX
            import warnings

            warnings.warn(f"tokenization mismatch: {cur_len} vs {total_len} (ignored)")

    return {
        "input_ids": [np.asarray(x, np.int64) for x in input_ids],
        "labels": [np.asarray(x, np.int64) for x in targets],
    }


class LLMTokenization:
    """Default tokenization callable for DexDataset (exp layer contract)."""

    def __init__(self, tokenizer, chat_template: str = "dexbotic", num_image_tokens: int = 1):
        self.tokenizer = tokenizer
        self.chat_template = chat_template
        self.num_image_tokens = num_image_tokens

    def __call__(self, conversations, has_image: bool = True) -> dict:
        if conversations and isinstance(conversations[0], dict):
            conversations = [conversations]
        out = tokenize_dexbotic(
            conversations,
            self.tokenizer,
            has_image=has_image,
            chat_template=self.chat_template,
            num_image_tokens=self.num_image_tokens,
        )
        return {"input_ids": out["input_ids"][0], "labels": out["labels"][0]}


class DummyTokenization:
    """Norm-stats pipeline stub (data/dataset/tokenization.py:15-21)."""

    def __call__(self, conversations, has_image: bool = True) -> dict:
        z = np.zeros((1,), np.int64)
        return {"input_ids": z, "labels": z}


class Pi0Tokenization:
    """pi0: fixed-length (48) plain prompt tokens, zero padded
    (reference: tokenization/process.py:116-127)."""

    def __init__(self, tokenizer, max_len: int = 48):
        self.tokenizer = tokenizer
        self._max_len = max_len

    def __call__(self, conversations, has_image: bool = True) -> dict:
        if conversations and isinstance(conversations[0], list):
            conversations = conversations[0]
        prompt = conversations[0]["value"]
        cleaned = prompt.strip().replace("\n", " ").replace("_", " ")
        if hasattr(self.tokenizer, "sp_model"):  # HF Gemma tokenizer
            tokens = self.tokenizer.sp_model.encode(cleaned, add_bos=True)
            tokens = tokens + self.tokenizer.sp_model.encode("\n")
        else:
            tokens = self.tokenizer.encode(cleaned)
            nl = self.tokenizer.encode("\n")
            tokens = tokens + (nl[1:] if nl and nl[0] == getattr(self.tokenizer, "bos_token_id", None) else nl)
        tokens = tokens[: self._max_len]
        n = len(tokens)
        tokens = tokens + [0] * (self._max_len - n)
        arr = np.asarray(tokens, np.int64)
        token_mask = np.arange(self._max_len) < n
        return {"input_ids": arr, "labels": arr.copy(), "token_mask": token_mask}


class DM0Tokenization:
    """DM0 'step'-template SFT format with the full mask surface
    (reference: tokenization/process.py:130-245): per-turn construction of
    input_ids + token_mask (real vs pad) + ar_mask (causal bits feeding
    DM0's prefix attention) + loss_mask (assistant content+separator only),
    fixed-length padded; labels = input_ids where loss_mask else IGNORE."""

    def __init__(self, tokenizer, max_len: int = 100, chat_template: str = "step"):
        self.tokenizer = tokenizer
        self._max_len = max_len
        self.chat_template = chat_template

    def _encode(self, text: str) -> list:
        if hasattr(self.tokenizer, "encode"):
            try:  # HF tokenizers take add_special_tokens
                return list(self.tokenizer.encode(text, add_special_tokens=False))
            except TypeError:
                return list(self.tokenizer.encode(text, add_bos=False))
        return list(self.tokenizer(text).input_ids)

    def __call__(self, conversations, has_image: bool = True) -> dict:
        if conversations and isinstance(conversations[0], list):
            conversations = conversations[0]
        conv = conversation_lib.conv_templates[self.chat_template].copy()
        roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
        seps = {conv.roles[0]: conv.sep, conv.roles[1]: conv.sep2}

        tokens = self._encode(f"{conv.system}{conv.sep}")
        token_mask = [True] * len(tokens)
        ar_mask = [1] * len(tokens)
        loss_mask = [False] * len(tokens)

        convs = list(conversations)
        # drop an empty trailing assistant turn (OpenPI alignment)
        if convs and convs[-1].get("from") == "gpt" and not convs[-1].get("value"):
            convs.pop()

        for msg in convs:
            role_key = msg.get("from", "human")
            if role_key not in roles:
                continue
            role = roles[role_key]
            text = (msg.get("value") or "").strip().replace("\n", " ")
            role_tokens = self._encode(f"{role}: ")
            tokens += role_tokens
            token_mask += [True] * len(role_tokens)
            ar_mask += [1] * len(role_tokens)
            loss_mask += [False] * len(role_tokens)

            content = f"{text}{seps[role]}" if text else ""
            content_tokens = self._encode(content)
            tokens += content_tokens
            token_mask += [True] * len(content_tokens)
            ar_mask += [1] * len(content_tokens)
            loss_mask += [role == roles["gpt"]] * len(content_tokens)

        pad_id = getattr(self.tokenizer, "pad_token_id", 0) or 0
        n = len(tokens)
        if n < self._max_len:
            pad = self._max_len - n
            tokens += [pad_id] * pad
            token_mask += [False] * pad
            ar_mask += [0] * pad
            loss_mask += [False] * pad
        else:
            tokens = tokens[: self._max_len]
            token_mask = token_mask[: self._max_len]
            ar_mask = ar_mask[: self._max_len]
            loss_mask = loss_mask[: self._max_len]

        input_ids = np.asarray(tokens, np.int64)
        loss_arr = np.asarray(loss_mask)
        labels = np.where(loss_arr, input_ids, IGNORE_INDEX)
        return {
            "input_ids": input_ids,
            "labels": labels,
            "token_mask": np.asarray(token_mask),
            "ar_mask": np.asarray(ar_mask, np.int64),
            "loss_mask": loss_arr,
        }
