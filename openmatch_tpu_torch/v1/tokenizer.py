"""Word-level tokenizer for the KNRM-family models.

The port's own copy of ``openmatch_tpu/v1/tokenizer.py``: NLTK
``word_tokenize``, optional stopword removal and Porter stemming; ids from
a vocab file or a GloVe-style embedding file (token id 0 is [PAD], mask =
id != 0). Where NLTK or its data is absent, both packages fall back to the
same regex. Whether ``word_tokenize`` works is probed at the first call
and remembered, so a machine without NLTK does not pay a failed import for
every text.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple


class WordTokenizer:
    _regex = re.compile(r"[a-zA-Z0-9]+|[^\w\s]")

    def __init__(
        self,
        vocab: Optional[str] = None,
        pretrained: Optional[str] = None,
        if_swr: bool = True,
        if_stem: bool = True,
        sp_tok: str = "[PAD]",
    ):
        self._sp_tok = sp_tok
        self._nltk_tokenize = None  # probed at the first tokenize()
        self._stopwords = set()
        self._stemmer = None
        if if_swr:
            try:
                from nltk.corpus import stopwords

                self._stopwords = set(stopwords.words("english"))
            except Exception:
                pass
        if if_stem:
            try:
                from nltk.stem import PorterStemmer

                self._stemmer = PorterStemmer().stem
            except Exception:
                pass

        self._token2id = {sp_tok: 0}
        self._id2token = {0: sp_tok}
        self._embed_matrix = None
        if pretrained is not None:
            self.from_pretrained(pretrained)
        elif vocab is not None:
            self.from_vocab(vocab)
        else:
            raise ValueError("Tokenizer must be initialized with vocab or pretrained.")

    # -- vocab loading ---------------------------------------------------

    def from_vocab(self, vocab_path: str):
        tid = 1
        with open(vocab_path) as f:
            for line in f:
                token = line.rstrip("\n")
                self._id2token[tid] = token
                self._token2id[token] = tid
                tid += 1

    def from_pretrained(self, glove_path: str):
        """GloVe text format: ``token v1 v2 ... vd`` per line; id 0 stays a
        zero PAD row (reference tokenizer.py:88-101)."""
        tid = 1
        matrix = []
        with open(glove_path) as f:
            for line in f:
                parts = line.split()
                self._id2token[tid] = parts[0]
                self._token2id[parts[0]] = tid
                matrix.append([float(x) for x in parts[1:]])
                tid += 1
        matrix.insert(0, [0.0] * len(matrix[0]))
        self._embed_matrix = matrix

    # -- tokenization ----------------------------------------------------

    def tokenize(self, text: str) -> List[str]:
        if self._nltk_tokenize is None:
            try:
                from nltk import word_tokenize

                word_tokenize(text)
                self._nltk_tokenize = word_tokenize
            except Exception:
                self._nltk_tokenize = False
        if self._nltk_tokenize:
            try:
                return self._nltk_tokenize(text)
            except Exception:
                pass
        return self._regex.findall(text)

    def process(self, text: str, max_len: int) -> Tuple[List[int], List[int]]:
        tokens = self.tokenize(text)
        if self._stopwords:
            kept = []
            for t in tokens:
                if t not in self._stopwords:
                    kept.append(t)
                    if len(kept) >= max_len:
                        break
            tokens = kept
        # cut to max_len first: the tokens past it never reach the output
        tokens = tokens[:max_len]
        if self._stemmer:
            tokens = [self._stemmer(t) for t in tokens]
        get = self._token2id.get
        ids = [get(t, 0) for t in tokens]
        ids += [get(self._sp_tok, 0)] * (max_len - len(ids))
        masks = [0 if tid == 0 else 1 for tid in ids]
        return ids, masks

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self._token2id.get(t, 0) for t in tokens]

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self._id2token.get(i, self._sp_tok) for i in ids]

    def get_vocab_size(self) -> int:
        return len(self._token2id)

    def get_embed_dim(self) -> int:
        return len(self._embed_matrix[0]) if self._embed_matrix else -1

    def get_embed_matrix(self):
        return self._embed_matrix
