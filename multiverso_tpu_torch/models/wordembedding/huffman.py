"""Huffman encoder for hierarchical softmax (the port's copy of
``multiverso_tpu/models/wordembedding/huffman.py``).

Behavioral equivalent of reference
Applications/WordEmbedding/src/huffman_encoder.h/.cpp: build a Huffman tree
over word frequencies; each word gets (codes, points) — the 0/1 turns and
the inner-node ids along its root path. Inner node ids are offset into the
output-embedding table rows [0, vocab_size-1) like word2vec's syn1.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Sequence


@dataclass
class HuffLabelInfo:
    codes: List[int] = field(default_factory=list)    # 0/1 path turns
    points: List[int] = field(default_factory=list)   # inner-node row ids


class HuffmanEncoder:
    def __init__(self):
        self._label_info: List[HuffLabelInfo] = []
        self.max_code_length = 0

    def BuildFromTermFrequency(self, counts: Sequence[int]) -> None:
        n = len(counts)
        if n == 0:
            return
        # standard two-array word2vec construction via a heap
        heap = [(c, i) for i, c in enumerate(counts)]
        heapq.heapify(heap)
        parent = [0] * (2 * n)
        binary = [0] * (2 * n)
        next_inner = n
        while len(heap) > 1:
            (c1, i1) = heapq.heappop(heap)
            (c2, i2) = heapq.heappop(heap)
            parent[i1] = next_inner
            parent[i2] = next_inner
            binary[i2] = 1
            heapq.heappush(heap, (c1 + c2, next_inner))
            next_inner += 1
        root = next_inner - 1
        self._label_info = []
        self.max_code_length = 0
        for w in range(n):
            codes, points = [], []
            node = w
            while node != root:
                codes.append(binary[node])
                points.append(parent[node] - n)  # inner-node row id
                node = parent[node]
            codes.reverse()
            points.reverse()
            self._label_info.append(HuffLabelInfo(codes, points))
            self.max_code_length = max(self.max_code_length, len(codes))

    def GetLabelInfo(self, word_idx: int) -> HuffLabelInfo:
        return self._label_info[word_idx]

    def VocabSize(self) -> int:
        return len(self._label_info)
