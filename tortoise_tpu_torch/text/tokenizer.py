"""BPE tokenizer covering both the reference's runtime semantics and
upstream tortoise-tts semantics.

The reference has *two* tokenizations in play:

1. **Runtime path** (`gpt_tokenize`, common.cpp:282-339): regex word split
   then *greedy longest-substring* matching against the vocab — it ignores
   the merges list entirely. This is what `./tortoise --message ...`
   actually executes. (Verified bit-for-bit against a g++ build of the
   reference tokenizer; e.g. "test" -> ["te","st"] = [136,63].)
2. **Fixture path**: the seeded regression tests bypass the tokenizer and
   hardcode ids produced by upstream tortoise-tts's *merge-based* BPE
   (main.cpp:6267-6269, and the commented examples at main.cpp:5047-5063;
   e.g. "test" -> ["t","est"] = [33,218]).

We implement both: ``method="greedy"`` (default, runtime parity) and
``method="bpe"`` (upstream parity, used when reproducing fixture token
streams). Word splitting replicates ``gpt_split_words`` (common.cpp:268-280):
GPT-2-style regex with ``[SPACE]/[UNK]/[STOP]`` literals as leading
alternatives (runtime special tokens are never registered —
``add_special_token`` is dead code in the reference).

Vocab loading parses the JSON properly. ``reference_quirks=True``
additionally reproduces the reference's hand-rolled flat-scan
``json_parse`` (common.cpp:166-255) side effects on this file: the
top-level ``"version":"1.0"`` pair enters the vocab as ``version -> 1``
(stoi of "1.0"), and ``"[STOP]":0`` is lost (consumed while skipping the
``"vocab":{`` non-string value). Irrelevant unless the text contains the
literal word "version".
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

_WORD_SPLIT = re.compile(
    r"\[SPACE\]|\[UNK\]|\[STOP\]|'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?[a-zA-Z]+| ?[0-9]+| ?[^\s\[\]a-zA-Z0-9]+|\s+(?!\S)|\s+"
)

START_TEXT_TOKEN = 255
STOP_TEXT_TOKEN = 0


def load_vocab(
    path: str, reference_quirks: bool = False
) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Load (vocab, merges) from a HF-tokenizers-style tokenizer.json."""
    with open(path, "r", encoding="utf-8") as f:
        spec = json.load(f)
    vocab = {}
    for key, idx in spec["model"]["vocab"].items():
        key = key.replace("Ġ", " ").replace("Ċ", "\n")
        vocab[key] = int(idx)
    for tok in spec.get("added_tokens", []):
        vocab.setdefault(tok["content"], int(tok["id"]))
    merges = []
    for m in spec["model"].get("merges", []):
        a, b = m.split(" ") if isinstance(m, str) else m
        # same Gdot/Cdot normalization as the vocab keys above — a merge
        # rank keyed on the raw "Ġt" symbol could never match the
        # normalized " t" parts the BPE loop builds, stalling every
        # space-prefixed merge
        merges.append((a.replace("Ġ", " ").replace("Ċ", "\n"),
                       b.replace("Ġ", " ").replace("Ċ", "\n")))
    if reference_quirks:
        vocab.pop("[STOP]", None)
        vocab["version"] = 1
    return vocab, merges


class Tokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Optional[Sequence[Tuple[str, str]]] = None,
        native: bool = True,
    ):
        self.token_to_id = vocab
        self.id_to_token = {i: t for t, i in vocab.items()}
        self._max_token_len = max(len(t) for t in vocab)
        self.merge_rank = {m: r for r, m in enumerate(merges or [])}
        self._native = None
        if native:
            try:
                from tortoise_tpu_torch.native import NativeTokenizer

                self._native = NativeTokenizer(vocab)
            except Exception:
                self._native = None

    @classmethod
    def from_file(cls, path: str, reference_quirks: bool = False) -> "Tokenizer":
        return cls(*load_vocab(path, reference_quirks))

    def split_words(self, text: str) -> List[str]:
        return _WORD_SPLIT.findall(text)

    # -- greedy (reference runtime parity) ---------------------------------
    def _encode_word_greedy(self, word: str, ids: List[int]) -> None:
        t2i = self.token_to_id
        i, n = 0, len(word)
        while i < n:
            for j in range(min(n, i + self._max_token_len), i, -1):
                tok = t2i.get(word[i:j])
                if tok is not None:
                    ids.append(tok)
                    i = j
                    break
            else:
                i += 1  # unknown character: dropped, like the reference

    # -- merge-based BPE (upstream tortoise-tts parity) ---------------------
    def _encode_word_bpe(self, word: str, ids: List[int]) -> None:
        if word in self.token_to_id:  # specials like [SPACE]
            ids.append(self.token_to_id[word])
            return
        parts = list(word)
        ranks = self.merge_rank
        while len(parts) > 1:
            best, best_i = None, -1
            for i in range(len(parts) - 1):
                r = ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best is None or r < best):
                    best, best_i = r, i
            if best is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        for p in parts:
            tok = self.token_to_id.get(p)
            if tok is None:
                tok = self.token_to_id.get("[UNK]")
            if tok is not None:
                ids.append(tok)

    def encode(self, text: str, method: str = "greedy") -> List[int]:
        if method not in ("greedy", "bpe"):
            # an unknown value must not silently select the OTHER plane
            # (a 'Greedy' typo flipping to merge-BPE changes every token)
            raise ValueError(f"unknown tokenizer method {method!r}; "
                             f"expected 'greedy' or 'bpe'")
        ids: List[int] = []
        if method == "greedy" and self._native is not None:
            for word in self.split_words(text):
                try:
                    ids.extend(self._native.encode_word(word))
                except UnicodeEncodeError:
                    # lone surrogates (json.loads accepts \ud800 escapes)
                    # can't cross the UTF-8 C ABI; the pure plane matches
                    # by codepoint and handles them — same ids either way
                    self._encode_word_greedy(word, ids)
            return ids
        enc = (
            self._encode_word_greedy
            if method == "greedy"
            else self._encode_word_bpe
        )
        for word in self.split_words(text):
            enc(word, ids)
        return ids

    def encode_pipeline(self, message: str, method: str = "greedy") -> List[int]:
        """Full CLI-path encode: space substitution + start/stop wrapping
        (main.cpp:6559-6567)."""
        message = message.replace(" ", "[SPACE]")
        return [START_TEXT_TOKEN] + self.encode(message, method) + [STOP_TEXT_TOKEN]

    def decode(self, ids) -> str:
        return "".join(self.id_to_token.get(int(i), "") for i in ids)
