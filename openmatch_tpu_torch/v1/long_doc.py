"""Long-document and entity inputs: BertMaxP's passage windows and EDRM's
entity fields.

The port's own copy of ``openmatch_tpu/v1/long_doc.py``: a document is
split into ``num_passages`` token windows, each joined with the query as a
separate BERT input, which BertMaxP max-pools; ``EDRMCollator`` adds entity
ids, masks and description tokens to the word inputs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def split_doc_tokens(doc_tokens: List[int], max_doc_len: int, num_passages: int = 4) -> List[List[int]]:
    """Split a token list into ``num_passages`` windows of ``max_doc_len``
    (padded by repetition of the empty tail as in the reference: missing
    windows are empty)."""
    windows = []
    for p in range(num_passages):
        windows.append(doc_tokens[p * max_doc_len : (p + 1) * max_doc_len])
    return windows


class BertMaxPCollator:
    """[{query, doc}] → input_ids/input_mask/segment_ids of shape
    [B, num_passages, q_len + doc_len + 3].

    ``mode="train"`` with ranking examples ({query, doc_pos, doc_neg})
    instead emits pos_/neg_ prefixed tensor pairs (the reference
    BertMaxPDataset train collate,
    v1/OpenMatch/data/datasets/bert_maxp_dataset.py), letting BertMaxP
    train through the v1 pairwise loop (-maxp, v1/train.py:623-630)."""

    def __init__(self, tokenizer, max_query_len: int = 32, max_doc_len: int = 221,
                 num_passages: int = 4, mode: str = "dev", task: str = "ranking"):
        self.tokenizer = tokenizer
        self.q_len = max_query_len
        self.d_len = max_doc_len
        self.num_passages = num_passages
        self.seq_len = max_query_len + max_doc_len + 3
        self.mode = mode
        self.task = task

    def _encode_window(self, q_tokens: List[int], d_tokens: List[int]):
        tok = self.tokenizer
        ids = [tok.cls_token_id] + q_tokens[: self.q_len] + [tok.sep_token_id]
        seg_boundary = len(ids)
        ids = ids + d_tokens[: self.d_len] + [tok.sep_token_id]
        ids = ids[: self.seq_len]
        mask = [1] * len(ids)
        seg = [0] * min(seg_boundary, len(ids)) + [1] * max(len(ids) - seg_boundary, 0)
        pad = self.seq_len - len(ids)
        return (
            ids + [tok.pad_token_id] * pad,
            mask + [0] * pad,
            seg + [0] * pad,
        )

    def _doc_tensors(self, batch: List[dict], doc_key: str):
        tok = self.tokenizer
        all_ids, all_mask, all_seg = [], [], []
        for ex in batch:
            q_tokens = tok.encode(ex["query"], add_special_tokens=False)
            d_tokens = tok.encode(ex[doc_key], add_special_tokens=False)
            rows = [
                self._encode_window(q_tokens, window)
                for window in split_doc_tokens(d_tokens, self.d_len, self.num_passages)
            ]
            all_ids.append([r[0] for r in rows])
            all_mask.append([r[1] for r in rows])
            all_seg.append([r[2] for r in rows])
        return {
            "input_ids": np.asarray(all_ids, np.int32),
            "input_mask": np.asarray(all_mask, np.int32),
            "segment_ids": np.asarray(all_seg, np.int32),
        }

    def __call__(self, batch: List[dict]) -> Dict[str, np.ndarray]:
        if self.mode == "train" and self.task == "ranking":
            out: Dict[str, np.ndarray] = {}
            out.update({f"pos_{k}": v
                        for k, v in self._doc_tensors(batch, "doc_pos").items()})
            out.update({f"neg_{k}": v
                        for k, v in self._doc_tensors(batch, "doc_neg").items()})
            return out
        out = self._doc_tensors(batch, "doc")
        if "label" in batch[0]:
            out["label"] = np.asarray([e["label"] for e in batch], np.int32)
        if "query_id" in batch[0]:
            out["query_id"] = [e["query_id"] for e in batch]
            out["doc_id"] = [e.get("doc_id") for e in batch]
        if "retrieval_score" in batch[0]:
            out["retrieval_score"] = np.asarray([e["retrieval_score"] for e in batch], np.float32)
        return out


class EDRMCollator:
    """Entity-duet inputs for EDRM: word ids/masks plus entity ids/masks and
    fixed-width entity-description token blocks.

    Examples carry optional ``query_ent``/``doc_ent`` (lists of entity
    surface strings) and ``query_des``/``doc_des`` (entity description
    strings, one per entity); missing entities pad with id 0. Train-ranking
    examples instead carry ``doc_pos``/``doc_neg`` (+ ``doc_pos_ent``,
    ``doc_pos_des``, ``doc_neg_ent``, ``doc_neg_des``), mirroring the
    reference EDRMDataset pairwise collate
    (v1/OpenMatch/data/datasets/edrm_dataset.py).
    """

    def __init__(self, word_tokenizer, ent_tokenizer, max_query_len: int = 10,
                 max_doc_len: int = 256, max_ent_num: int = 3, max_des_len: int = 20,
                 mode: str = "dev", task: str = "ranking"):
        self.wtok = word_tokenizer
        self.etok = ent_tokenizer
        self.q_len = max_query_len
        self.d_len = max_doc_len
        self.max_ent = max_ent_num
        self.des_len = max_des_len
        self.mode = mode
        self.task = task

    def _entities(self, ents: List[str]):
        ents = (list(ents) + [""] * self.max_ent)[: self.max_ent]
        ids = [self.etok._token2id.get(e, 0) if e else 0 for e in ents]
        masks = [0 if i == 0 else 1 for i in ids]
        return ids, masks

    def _descriptions(self, descs: List[str]):
        descs = (list(descs) + [""] * self.max_ent)[: self.max_ent]
        out = []
        for text in descs:
            ids, _ = self.wtok.process(text or "", self.des_len)
            out.extend(ids)
        return out  # [max_ent * des_len]

    def _doc_fields(self, batch: List[dict], out: Dict[str, np.ndarray],
                    src_prefix: str, dst_prefix: str):
        """Tokenize one document slot (``doc``/``doc_pos``/``doc_neg``) into
        ``{dst_prefix}_wrd/ent/des`` arrays."""
        ids, masks = zip(*[self.wtok.process(e[src_prefix], self.d_len) for e in batch])
        out[f"{dst_prefix}_wrd_idx"] = np.asarray(ids, np.int32)
        out[f"{dst_prefix}_wrd_mask"] = np.asarray(masks, np.float32)
        ent = [self._entities(e.get(f"{src_prefix}_ent", [])) for e in batch]
        out[f"{dst_prefix}_ent_idx"] = np.asarray([x[0] for x in ent], np.int32)
        out[f"{dst_prefix}_ent_mask"] = np.asarray([x[1] for x in ent], np.float32)
        out[f"{dst_prefix}_des_idx"] = np.asarray(
            [self._descriptions(e.get(f"{src_prefix}_des", [])) for e in batch], np.int32
        )

    def __call__(self, batch: List[dict]) -> Dict[str, np.ndarray]:
        def proc(texts, max_len):
            ids, masks = zip(*[self.wtok.process(t, max_len) for t in texts])
            return np.asarray(ids, np.int32), np.asarray(masks, np.float32)

        out: Dict[str, np.ndarray] = {}
        out["query_wrd_idx"], out["query_wrd_mask"] = proc([e["query"] for e in batch], self.q_len)
        q_ent = [self._entities(e.get("query_ent", [])) for e in batch]
        out["query_ent_idx"] = np.asarray([x[0] for x in q_ent], np.int32)
        out["query_ent_mask"] = np.asarray([x[1] for x in q_ent], np.float32)
        out["query_des_idx"] = np.asarray([self._descriptions(e.get("query_des", [])) for e in batch], np.int32)
        if self.mode == "train" and self.task == "ranking":
            self._doc_fields(batch, out, "doc_pos", "doc_pos")
            self._doc_fields(batch, out, "doc_neg", "doc_neg")
        else:
            self._doc_fields(batch, out, "doc", "doc")
            if "label" in batch[0]:
                out["label"] = np.asarray([e["label"] for e in batch], np.int32)
        if "query_id" in batch[0]:
            out["query_id"] = [e["query_id"] for e in batch]
            out["doc_id"] = [e.get("doc_id") for e in batch]
        if "retrieval_score" in batch[0]:
            out["retrieval_score"] = np.asarray(
                [e["retrieval_score"] for e in batch], np.float32
            )
        return out
