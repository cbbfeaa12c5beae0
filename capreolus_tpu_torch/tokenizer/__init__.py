"""Tokenizer modules: ``lucene`` (the Lucene English analyzer) and its
``anserini`` alias, as in the JAX package's ``tokenizer/__init__.py``. The
BERT wordpiece and punkt tokenizers come with later slices."""

from __future__ import annotations

from capreolus_tpu_torch.analysis import get_analyzer
from capreolus_tpu_torch.core import ConfigOption, ModuleBase, import_all_modules, register_module_type


@register_module_type
class Tokenizer(ModuleBase):
    """Base class for Tokenizer modules."""

    module_type = "tokenizer"

    def tokenize(self, sentences):
        raise NotImplementedError


@Tokenizer.register
class LuceneTokenizer(Tokenizer):
    """English analyzer with Lucene semantics."""

    module_name = "lucene"
    config_spec = [
        ConfigOption("keepstops", True, "keep stopwords"),
        ConfigOption("stemmer", "none", "stemmer: porter or none"),
    ]

    def build(self):
        self._analyzer = get_analyzer(stemmer=self.config["stemmer"], keep_stopwords=self.config["keepstops"])

    def tokenize(self, sentences):
        if not sentences:
            return []
        if isinstance(sentences, str):
            return self._analyzer.analyze(sentences)
        return [self._analyzer.analyze(s) for s in sentences]


@Tokenizer.register
class AnseriniTokenizerAlias(LuceneTokenizer):
    """Alias so configs using tokenizer.name=anserini keep working."""

    module_name = "anserini"


import_all_modules(__file__, __package__)
