"""Pure-Python sentencepiece: ModelProto loader + unigram/BPE encoders.

The reference's Pi0Tokenization calls ``tokenizer.sp_model.encode(...)`` on a
``transformers.GemmaTokenizer`` — i.e. the native ``sentencepiece`` package
(reference: dexbotic/tokenization/process.py:116-127), which is absent from
this image.  This module replaces it with a self-contained reader of the
serialized ``ModelProto`` (``tokenizer.model``) plus the two sentencepiece
inference algorithms, so a raw ``.model`` file is all that's needed:

* **unigram** (``unigram_model.cc`` semantics): Viterbi max-score
  segmentation over the piece vocabulary; unknown surface maps to ``unk_id``
  at ``min_score - 10``; consecutive unknowns fuse into one ``unk_id``;
  ``byte_fallback`` expands unknown chars to their ``<0xXX>`` byte pieces.
* **BPE** (``bpe_model.cc`` semantics): start from single characters and
  repeatedly merge the adjacent pair whose concatenation is the
  highest-scoring vocab piece (leftmost on ties); leftover symbols fall back
  to bytes or ``unk_id``.

Normalization interprets the NormalizerSpec exactly: when the model ships a
``precompiled_charsmap`` the darts-clone trie is decoded and applied with
sentencepiece's longest-prefix-match semantics (DartsCharsMap — so the
``nmt_nfkc`` family normalizes IDENTICALLY to native sentencepiece, not via
a Python-NFKC approximation); NFKC remains the fallback when the blob is
absent, plus ``add_dummy_prefix`` / ``remove_extra_whitespaces`` /
``escape_whitespaces``.  Parity is pinned against the HF ``tokenizers``
Rust implementations (Unigram/BPE models, Precompiled normalizer) in
tests/test_spm.py.
"""

from __future__ import annotations

import dataclasses
import struct
import unicodedata

__all__ = ["SentencePieceModel", "SpmTokenizer", "load_spm"]

# SentencePiece.Type enum (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_WHITESPACE = "▁"  # ▁ (LOWER ONE EIGHTH BLOCK), sentencepiece's space


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format reader (only what ModelProto needs)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    val = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, raw_value) over one message."""
    i, n = 0, len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, i = _read_varint(buf, i)
        elif wt == 1:  # 64-bit
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:  # 32-bit
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield fn, wt, v


@dataclasses.dataclass(frozen=True)
class _Piece:
    piece: str
    score: float
    type: int


def _parse_piece(buf: bytes) -> _Piece:
    piece, score, ptype = "", 0.0, NORMAL
    for fn, _, v in _fields(buf):
        if fn == 1:
            piece = v.decode("utf-8")
        elif fn == 2:
            score = struct.unpack("<f", v)[0]
        elif fn == 3:
            ptype = v
    return _Piece(piece, score, ptype)


def _parse_trainer_spec(buf: bytes) -> dict:
    # field numbers from sentencepiece_model.proto TrainerSpec
    out = {"model_type": 1, "byte_fallback": False,
           "unk_id": 0, "bos_id": 1, "eos_id": 2, "pad_id": -1}
    for fn, _, v in _fields(buf):
        if fn == 3:
            out["model_type"] = v  # 1=unigram 2=bpe 3=word 4=char
        elif fn == 35:
            out["byte_fallback"] = bool(v)
        elif fn == 40:
            out["unk_id"] = _signed(v)
        elif fn == 41:
            out["bos_id"] = _signed(v)
        elif fn == 42:
            out["eos_id"] = _signed(v)
        elif fn == 43:
            out["pad_id"] = _signed(v)
    return out


def _parse_normalizer_spec(buf: bytes) -> dict:
    out = {"name": "nmt_nfkc", "add_dummy_prefix": True,
           "remove_extra_whitespaces": True, "escape_whitespaces": True,
           "precompiled_charsmap": b""}
    for fn, _, v in _fields(buf):
        if fn == 1:
            out["name"] = v.decode("utf-8")
        elif fn == 2:
            out["precompiled_charsmap"] = v
        elif fn == 3:
            out["add_dummy_prefix"] = bool(v)
        elif fn == 4:
            out["remove_extra_whitespaces"] = bool(v)
        elif fn == 5:
            out["escape_whitespaces"] = bool(v)
    return out


def _utf8_len(lead: int) -> int:
    if lead < 0x80:
        return 1
    if 0xC0 <= lead < 0xE0:
        return 2
    if 0xE0 <= lead < 0xF0:
        return 3
    if 0xF0 <= lead < 0xF8:
        return 4
    return 1  # invalid lead byte


class DartsCharsMap:
    """NormalizerSpec.precompiled_charsmap interpreter.

    The blob is ``[uint32 trie_size (LE)][darts-clone double-array trie]
    [NUL-terminated replacement blob]`` (sentencepiece normalizer.cc
    ``DecodePrecompiledCharsMap``); the trie maps UTF-8 source substrings to
    byte offsets of their replacements.  Unit layout is darts-clone's
    ``DoubleArrayUnit``: label = unit & 0x800000FF, has_leaf = bit 8,
    offset = (unit >> 10) << ((unit & (1 << 9)) >> 6), leaf value =
    unit & 0x7FFFFFFF.  Normalization is sentencepiece's NormalizePrefix
    loop: greedy longest trie match at each position, else copy one UTF-8
    character (invalid bytes become U+FFFD).  Parity vs the HF tokenizers
    Rust ``Precompiled`` normalizer is pinned in tests/test_spm.py."""

    def __init__(self, blob: bytes):
        (trie_size,) = struct.unpack("<I", blob[:4])
        trie = blob[4 : 4 + trie_size]
        self.units = struct.unpack(f"<{len(trie) // 4}I", trie)
        self.norm = blob[4 + trie_size :]

    def longest_match(self, data: bytes, start: int):
        """(replacement bytes | None, consumed length) of the longest trie
        prefix at data[start:]."""
        units = self.units
        n_units = len(units)
        unit = units[0]
        node_pos = (unit >> 10) << ((unit & (1 << 9)) >> 6)
        rep, length = None, 0
        for i in range(start, len(data)):
            c = data[i]
            node_pos ^= c
            if node_pos >= n_units:
                break
            unit = units[node_pos]
            if (unit & 0x800000FF) != c:
                break
            node_pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                value = units[node_pos] & 0x7FFFFFFF
                end = self.norm.index(0, value)
                rep, length = self.norm[value:end], i - start + 1
        return rep, length

    def normalize(self, text: str) -> str:
        data = text.encode("utf-8")
        out = bytearray()
        i, n = 0, len(data)
        while i < n:
            rep, ln = self.longest_match(data, i)
            if rep is not None:
                out += rep
                i += ln
                continue
            ln = _utf8_len(data[i])
            chunk = data[i : i + ln]
            try:
                chunk.decode("utf-8")
            except UnicodeDecodeError:
                chunk, ln = "�".encode(), 1
            out += chunk
            i += ln
        return out.decode("utf-8", "replace")


def _signed(v: int) -> int:
    # int32 fields are varint-encoded as their two's-complement uint64
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class SentencePieceModel:
    """Drop-in for ``sentencepiece.SentencePieceProcessor``'s encode surface."""

    def __init__(self, pieces: list[_Piece], trainer: dict, normalizer: dict):
        self.pieces = pieces
        self.model_type = trainer["model_type"]
        self.unk_id_ = trainer["unk_id"]
        self.bos_id_ = trainer["bos_id"]
        self.eos_id_ = trainer["eos_id"]
        self.pad_id_ = trainer["pad_id"]
        self.byte_fallback = trainer["byte_fallback"]
        self.normalizer_name = normalizer["name"]
        self.add_dummy_prefix = normalizer["add_dummy_prefix"]
        self.remove_extra_whitespaces = normalizer["remove_extra_whitespaces"]
        self.escape_whitespaces = normalizer["escape_whitespaces"]
        # exact sentencepiece normalization when the model ships its
        # precompiled charsmap; NFKC is only the fallback approximation
        blob = normalizer.get("precompiled_charsmap", b"")
        self.charsmap = DartsCharsMap(blob) if len(blob) > 4 else None

        # surface-matchable vocab: NORMAL + USER_DEFINED pieces only
        # (CONTROL/UNKNOWN/BYTE/UNUSED never match raw text directly)
        self._vocab: dict[str, int] = {}
        self._byte_ids: dict[int, int] = {}
        for i, p in enumerate(pieces):
            if p.type in (NORMAL, USER_DEFINED):
                self._vocab.setdefault(p.piece, i)
            elif p.type == BYTE and len(p.piece) == 6:  # "<0xAB>"
                self._byte_ids[int(p.piece[3:5], 16)] = i
        self._max_piece_len = max((len(p) for p in self._vocab), default=1)
        self._min_score = min((p.score for p in pieces if p.type == NORMAL),
                              default=0.0)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_bytes(cls, data: bytes) -> "SentencePieceModel":
        pieces: list[_Piece] = []
        trainer = _parse_trainer_spec(b"")
        normalizer = _parse_normalizer_spec(b"")
        for fn, _, v in _fields(data):
            if fn == 1:
                pieces.append(_parse_piece(v))
            elif fn == 2:
                trainer = _parse_trainer_spec(v)
            elif fn == 3:
                normalizer = _parse_normalizer_spec(v)
        if not pieces:
            raise ValueError("no pieces found: not a sentencepiece ModelProto?")
        return cls(pieces, trainer, normalizer)

    @classmethod
    def load(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    # -- sentencepiece-compatible surface ------------------------------------

    def vocab_size(self) -> int:
        return len(self.pieces)

    def piece_to_id(self, piece: str) -> int:
        for i, p in enumerate(self.pieces):
            if p.piece == piece:
                return i
        return self.unk_id_

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i].piece

    def unk_id(self) -> int:
        return self.unk_id_

    def bos_id(self) -> int:
        return self.bos_id_

    def eos_id(self) -> int:
        return self.eos_id_

    def pad_id(self) -> int:
        return self.pad_id_

    # -- normalization -------------------------------------------------------

    def normalize(self, text: str) -> str:
        if self.charsmap is not None:
            text = self.charsmap.normalize(text)
        elif "nfkc" in self.normalizer_name:
            text = unicodedata.normalize("NFKC", text)
        if self.remove_extra_whitespaces:
            text = " ".join(s for s in text.split(" ") if s)
        if self.add_dummy_prefix and text:
            text = " " + text
        if self.escape_whitespaces:
            text = text.replace(" ", _WHITESPACE)
        return text

    # -- encoding ------------------------------------------------------------

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False,
               out_type=int) -> list:
        s = self.normalize(text)
        if self.model_type == 2:
            ids = self._encode_bpe(s)
        else:
            ids = self._encode_unigram(s)
        if add_bos and self.bos_id_ >= 0:
            ids = [self.bos_id_] + ids
        if add_eos and self.eos_id_ >= 0:
            ids = ids + [self.eos_id_]
        if out_type is str:
            return [self.pieces[i].piece for i in ids]
        return ids

    def _char_fallback(self, surface: str) -> list[int]:
        """Ids for surface no piece covers: byte pieces, else one unk."""
        if self.byte_fallback and self._byte_ids:
            return [self._byte_ids.get(b, self.unk_id_)
                    for b in surface.encode("utf-8")]
        return [self.unk_id_]

    def _encode_unigram(self, s: str) -> list[int]:
        n = len(s)
        if n == 0:
            return []
        unk_score = self._min_score - 10.0
        best = [-1e30] * (n + 1)
        best[0] = 0.0
        back: list[tuple[int, int]] = [(-1, -1)] * (n + 1)
        vocab, max_len = self._vocab, self._max_piece_len
        for i in range(n):
            base = best[i]
            if base <= -1e29:
                continue
            lim = min(max_len, n - i)
            for L in range(1, lim + 1):
                pid = vocab.get(s[i:i + L])
                if pid is not None:
                    sc = base + self.pieces[pid].score
                    if sc > best[i + L]:
                        best[i + L] = sc
                        back[i + L] = (i, pid)
            # single-char unknown fallback keeps the lattice connected
            sc = base + unk_score
            if sc > best[i + 1]:
                best[i + 1] = sc
                back[i + 1] = (i, -1)
        segs: list[tuple[int, int, int]] = []  # (start, end, pid)
        i = n
        while i > 0:
            st, pid = back[i]
            segs.append((st, i, pid))
            i = st
        segs.reverse()
        out: list[int] = []
        unk_run = ""
        for st, en, pid in segs:
            if pid == -1:
                unk_run += s[st:en]
                continue
            if unk_run:  # consecutive unknowns fuse (unigram_model.cc)
                out.extend(self._char_fallback(unk_run))
                unk_run = ""
            out.append(pid)
        if unk_run:
            out.extend(self._char_fallback(unk_run))
        return out

    def _encode_bpe(self, s: str) -> list[int]:
        if not s:
            return []
        syms = list(s)
        # iterative best-pair merge; O(n^2) is fine for prompt-length text
        while len(syms) > 1:
            best_sc, best_i = None, -1
            for i in range(len(syms) - 1):
                pid = self._vocab.get(syms[i] + syms[i + 1])
                if pid is not None:
                    sc = self.pieces[pid].score
                    if best_sc is None or sc > best_sc:
                        best_sc, best_i = sc, i
            if best_i < 0:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        out: list[int] = []
        for sym in syms:
            pid = self._vocab.get(sym)
            if pid is not None:
                out.append(pid)
            else:
                out.extend(self._char_fallback(sym))
        return out

    # -- decoding ------------------------------------------------------------

    def decode(self, ids: list[int]) -> str:
        chunks: list[str] = []
        byte_run = bytearray()

        def flush():
            if byte_run:
                chunks.append(byte_run.decode("utf-8", errors="replace"))
                byte_run.clear()

        for i in ids:
            p = self.pieces[i]
            if p.type == BYTE:
                byte_run.append(int(p.piece[3:5], 16))
                continue
            flush()
            if p.type in (CONTROL, UNUSED):
                continue
            if p.type == UNKNOWN:
                chunks.append(" ⁇ ")  # sentencepiece's default unk_surface
                continue
            chunks.append(p.piece)
        flush()
        text = "".join(chunks)
        if self.escape_whitespaces:
            text = text.replace(_WHITESPACE, " ")
        if self.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text


class _Encoding(dict):
    """Minimal BatchEncoding stand-in: dict with attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


class SpmTokenizer:
    """HF-tokenizer-shaped wrapper around :class:`SentencePieceModel`.

    Exposes the attribute surface the tokenization layer touches
    (``sp_model`` for Pi0Tokenization's reference-parity path,
    ``encode``/``decode``/special-token ids for the generic paths) so a raw
    ``tokenizer.model`` file can stand in where the reference constructs a
    ``transformers.GemmaTokenizer`` (dexbotic/tokenization/process.py:116)."""

    def __init__(self, model: SentencePieceModel | str,
                 model_max_length: int = 2048):
        self.sp_model = (SentencePieceModel.load(model)
                         if isinstance(model, str) else model)
        self.model_max_length = model_max_length
        self.unk_token_id = self.sp_model.unk_id_
        self.bos_token_id = (self.sp_model.bos_id_
                             if self.sp_model.bos_id_ >= 0 else None)
        self.eos_token_id = (self.sp_model.eos_id_
                             if self.sp_model.eos_id_ >= 0 else None)
        self.pad_token_id = (self.sp_model.pad_id_
                             if self.sp_model.pad_id_ >= 0 else 0)

    @property
    def vocab_size(self) -> int:
        return self.sp_model.vocab_size()

    def __len__(self) -> int:
        return self.sp_model.vocab_size()

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        return self.sp_model.encode(text, add_bos=add_special_tokens)

    def __call__(self, text: str, add_special_tokens: bool = True):
        """HF-style call: the tokenize layer does `tokenizer(text).input_ids`
        (tokenization/tokenize.py:110,159,281)."""
        return _Encoding(input_ids=self.encode(
            text, add_special_tokens=add_special_tokens))

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.sp_model.decode(list(ids))

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.sp_model.piece_to_id(tokens)
        return [self.sp_model.piece_to_id(t) for t in tokens]

    def add_special_tokens(self, tokens) -> int:
        raise NotImplementedError(
            "SpmTokenizer is read-only (a raw .model file); policies that "
            "extend the vocab need an HF tokenizer dir (tokenizer_path)")


def load_spm(path: str, model_max_length: int = 2048) -> SpmTokenizer:
    return SpmTokenizer(path, model_max_length=model_max_length)
