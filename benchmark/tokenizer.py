"""A word tokenizer for seeded text: the word ``w<i>`` is the id ``i``.

Real tokenizers and text are not in the repository, so the traffic is
drawn as word ids and written as ``w<i>`` words; this tokenizer turns them
back into ids the way a BERT WordPiece tokenizer frames them ([CLS] ...
[SEP], truncated to ``max_length``, pad id 0). It offers the calls the
program's serving path makes (``encode_plus``, ``pad_token_id``)."""

from __future__ import annotations

CLS, SEP, PAD, UNK = 101, 102, 0, 100


class WordTokenizer:
    pad_token_id = PAD
    cls_token_id = CLS
    sep_token_id = SEP

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def word_id(self, word: str) -> int:
        if word.startswith("w") and word[1:].isdigit():
            i = int(word[1:])
            if i < self.vocab_size:
                return i
        return UNK

    def encode(self, text: str, max_length=None) -> list:
        ids = [self.word_id(w) for w in text.split()]
        if max_length is not None:
            ids = ids[:max_length - 2]
        return [CLS] + ids + [SEP]

    def encode_plus(self, text, truncation=None, max_length=None,
                    padding=False, return_attention_mask=False,
                    return_token_type_ids=False):
        return {"input_ids": self.encode(text, max_length)}

    @staticmethod
    def text(word_ids) -> str:
        return " ".join(f"w{int(i)}" for i in word_ids)
