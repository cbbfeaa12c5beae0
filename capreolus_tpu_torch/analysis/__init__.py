from capreolus_tpu_torch.analysis.analyzer import (
    LUCENE_ENGLISH_STOPWORDS,
    EnglishAnalyzer,
    WhitespaceAnalyzer,
    get_analyzer,
    standard_tokenize,
    strip_possessive,
)
from capreolus_tpu_torch.analysis.porter import porter_stem

__all__ = [
    "LUCENE_ENGLISH_STOPWORDS",
    "EnglishAnalyzer",
    "WhitespaceAnalyzer",
    "get_analyzer",
    "porter_stem",
    "standard_tokenize",
    "strip_possessive",
]
