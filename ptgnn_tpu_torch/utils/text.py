"""Vocabulary, identifier splitting, char tensorization (dpu-utils
semantics) and a small byte-pair encoding, as the JAX package's
``utils/text.py`` has them for the node embedders and the Graph2Class target
vocabulary."""
from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

_CAMEL_RE = re.compile(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])|(?<=[A-Za-z])(?=[0-9])|(?<=[0-9])(?=[A-Za-z])")


def split_identifier_into_parts(identifier: str) -> List[str]:
    """Split a code identifier into lowercase subtokens (snake_case,
    camelCase, PascalCase, digits and ALLCAPS runs)."""
    parts: List[str] = []
    for chunk in re.split(r"[_\W]+", identifier):
        if not chunk:
            continue
        for sub in _CAMEL_RE.split(chunk):
            if sub:
                parts.append(sub.lower())
    return parts


class Vocabulary:
    """Token<->id mapping with an UNK element (dpu-utils compatible API)."""

    def __init__(self, add_unk: bool = True, add_pad: bool = False):
        self.id_to_token: List[str] = []
        self.token_to_id: Dict[str, int] = {}
        if add_pad:
            self.add_or_get_id(self.get_pad())
        if add_unk:
            self.add_or_get_id(self.get_unk())

    @staticmethod
    def get_unk() -> str:
        return "%UNK%"

    @staticmethod
    def get_pad() -> str:
        return "%PAD%"

    def add_or_get_id(self, token: str) -> int:
        idx = self.token_to_id.get(token)
        if idx is not None:
            return idx
        idx = len(self.id_to_token)
        self.id_to_token.append(token)
        self.token_to_id[token] = idx
        return idx

    def is_unk(self, token: str) -> bool:
        return token not in self.token_to_id

    def get_id_or_unk(self, token: str) -> int:
        idx = self.token_to_id.get(token)
        if idx is not None:
            return idx
        return self.token_to_id[self.get_unk()]

    def get_id_or_unk_multiple(
        self, tokens: Iterable[str], pad_to_size: Optional[int] = None, padding_element: int = 0
    ) -> List[int]:
        ids = [self.get_id_or_unk(t) for t in tokens]
        if pad_to_size is not None:
            ids = ids[:pad_to_size] + [padding_element] * max(0, pad_to_size - len(ids))
        return ids

    def get_name_for_id(self, token_id: int) -> str:
        return self.id_to_token[token_id]

    def __len__(self) -> int:
        return len(self.id_to_token)

    def __contains__(self, token: str) -> bool:
        return token in self.token_to_id

    @staticmethod
    def create_vocabulary(
        tokens: Counter,
        max_size: int,
        count_threshold: int = 5,
        add_unk: bool = True,
        add_pad: bool = False,
    ) -> "Vocabulary":
        """Most-frequent-first vocabulary with a minimum-count threshold."""
        vocab = Vocabulary(add_unk=add_unk, add_pad=add_pad)
        num_base = len(vocab)
        for token, count in tokens.most_common(max_size - num_base):
            if count >= count_threshold:
                vocab.add_or_get_id(token)
        return vocab


class CharTensorizer:
    """Strings to fixed-length char-id arrays over a fixed alphabet: id 0 is
    PAD, 1 is UNK, then the alphabet in order (the JAX package's ids)."""

    ALPHABET = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789,;.!?:'\"/\\|_@#$%^&*~`+-=<>()[]{}"

    def __init__(self, max_num_chars: int, lower_case_all: bool = False, include_space: bool = False):
        self.max_num_chars = max_num_chars
        self.lower_case_all = lower_case_all
        alphabet = self.ALPHABET
        if lower_case_all:
            alphabet = "".join(dict.fromkeys(alphabet.lower()))
        if include_space:
            alphabet += " "
        self.__char_to_id = {c: i + 2 for i, c in enumerate(alphabet)}

    @property
    def max_char_length(self) -> int:
        return self.max_num_chars

    def num_chars_in_vocabulary(self) -> int:
        return len(self.__char_to_id) + 2

    def tensorize_str(self, data: str) -> np.ndarray:
        """[max_num_chars] int32: the first ``max_num_chars`` chars' ids, 0
        past the string's end."""
        if self.lower_case_all:
            data = data.lower()
        out = np.zeros(self.max_num_chars, dtype=np.int32)
        for i, c in enumerate(data[: self.max_num_chars]):
            out[i] = self.__char_to_id.get(c, 1)
        return out


class BpeVocabulary:
    """A byte-pair-encoding vocabulary, trained by greedy merges over word
    counts with an end-of-word marker; encoding applies the merges by rank,
    then maps each symbol to its id (UNK where it has none).

    The merges and ids equal the JAX package's bit for bit: every loop
    walks insertion-ordered dicts and counters, and ``most_common`` breaks a
    tie in count by first insertion, so the order of ``token_counter`` and
    of each round's words decides tied merges. Nothing here sorts."""

    END_OF_WORD = "</w>"

    def __init__(self, max_size: int):
        self.max_size = max_size
        self.__merges: Dict[Tuple[str, str], int] = {}
        self.__vocab = Vocabulary(add_unk=True)

    def create_vocabulary(self, token_counter: Counter) -> None:
        """The symbols (characters and the marker, most frequent first), then
        up to ``max_size`` minus their count merges, each of the most
        frequent adjacent pair while it occurs at least twice."""
        words: Dict[Tuple[str, ...], int] = {}
        charset: Counter = Counter()
        for word, count in token_counter.items():
            if not word:
                continue
            symbols = tuple(word) + (self.END_OF_WORD,)
            words[symbols] = words.get(symbols, 0) + count
            for ch in symbols:
                charset[ch] += count
        for ch, _ in charset.most_common():
            self.__vocab.add_or_get_id(ch)

        num_merges = max(0, self.max_size - len(self.__vocab))
        for merge_idx in range(num_merges):
            pair_counts: Counter = Counter()
            for symbols, count in words.items():
                for a, b in zip(symbols, symbols[1:]):
                    pair_counts[(a, b)] += count
            if not pair_counts:
                break
            best, count = pair_counts.most_common(1)[0]
            if count < 2:
                break
            self.__merges[best] = merge_idx
            merged_symbol = best[0] + best[1]
            self.__vocab.add_or_get_id(merged_symbol)
            new_words: Dict[Tuple[str, ...], int] = {}
            for symbols, cnt in words.items():
                out: List[str] = []
                i = 0
                while i < len(symbols):
                    if i + 1 < len(symbols) and (symbols[i], symbols[i + 1]) == best:
                        out.append(merged_symbol)
                        i += 2
                    else:
                        out.append(symbols[i])
                        i += 1
                key = tuple(out)
                new_words[key] = new_words.get(key, 0) + cnt
            words = new_words

    def tokenize(self, text: str) -> List[str]:
        """The symbols of ``text`` plus the marker, merged lowest rank first
        (the leftmost of equal ranks) until no learned pair is left."""
        symbols: List[str] = list(text) + [self.END_OF_WORD]
        while len(symbols) > 1:
            best_rank, best_pos = None, None
            for i, pair in enumerate(zip(symbols, symbols[1:])):
                rank = self.__merges.get(pair)
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_pos = rank, i
            if best_pos is None:
                break
            symbols[best_pos : best_pos + 2] = [symbols[best_pos] + symbols[best_pos + 1]]
        return symbols

    def get_id_or_unk_for_text(self, text: str) -> List[int]:
        return [self.__vocab.get_id_or_unk(s) for s in self.tokenize(text)]

    def __len__(self) -> int:
        return len(self.__vocab)
