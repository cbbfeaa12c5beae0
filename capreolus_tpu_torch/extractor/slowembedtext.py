"""SlowEmbedText: the embedtext variant the reranker zoo reads (the JAX
package's ``extractor/slowembedtext.py``; feeds TFKNRM, CDSSM, ConvKNRM, DUET,
HINT, POSITDRMM and TK).

Its features are EmbedText's. It adds the ``zerounk`` option: an
out-of-embedding term becomes id 0, the pad id, instead of its negative
exact-match id, so a document keeps pad ids among its terms. ``usecache`` is
accepted and stays out of the results path, as in the JAX extractor.
"""

from __future__ import annotations

from capreolus_tpu_torch.core import ConfigOption
from capreolus_tpu_torch.extractor import Extractor
from capreolus_tpu_torch.extractor.embedtext import EmbedText


@Extractor.register
class SlowEmbedText(EmbedText):
    module_name = "slowembedtext"
    config_spec = [
        ConfigOption("embeddings", "glove6b", "embeddings: glove6b, glove6b.50d, w2vnews, fasttext "
                     "(read from the embeddings cache), or random, random8, random300"),
        ConfigOption("zerounk", False, "use all-zero vectors for unknown terms (True) or exact-match ids (False)"),
        ConfigOption("calcidf", True, "compute idf for query terms from the index"),
        ConfigOption("maxqlen", 4, "maximum query length"),
        ConfigOption("maxdoclen", 800, "maximum doc length"),
        ConfigOption("usecache", False, "cache extracted features"),
    ]
    config_keys_not_in_path = ["usecache"]

    def _tok2vec(self, toks):
        ids = super()._tok2vec(toks)
        if self.config["zerounk"]:
            ids = [i if i > 0 else 0 for i in ids]
        return ids
