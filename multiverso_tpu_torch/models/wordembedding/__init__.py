"""WordEmbedding application (word2vec CBOW/skip-gram, HS/negative
sampling) on the port: streaming corpus reader into DataBlocks, per-block
row fetch from the matrix tables (+ the KV word count), the batched train
step as tensor code, delta push-back, block pipeline, and word2vec-format
export. Counterpart of ``multiverso_tpu/models/wordembedding``.
"""

from multiverso_tpu_torch.models.wordembedding.option import Option  # noqa: F401
from multiverso_tpu_torch.models.wordembedding.dictionary import Dictionary  # noqa: F401
from multiverso_tpu_torch.models.wordembedding.distributed import DistributedWordEmbedding  # noqa: F401
