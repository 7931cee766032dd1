"""Full-text search engine (host-side structures, device-side masks).

Reference: src/indexes/text/ — lexer (snowball stemming, stop words,
punctuation split), prefix/suffix radix trees over the word dictionary,
word -> Postings (ordered keys -> ordered positions with per-position
field bitmask), stem tree, and streaming term/proximity/fuzzy iterators.

Device design: tokenization and dictionary structures live on the host
(they are pointer-chasing workloads with no tensor-core affinity); the device
integration point is the predicate bitmask each text matcher resolves
to, which fuses into the Pallas distance kernels exactly like tag and
numeric predicates do.
"""

from valkey_search_tpu.text.lexer import Lexer, DEFAULT_PUNCTUATION, DEFAULT_STOP_WORDS
from valkey_search_tpu.text.stemmer import stem
from valkey_search_tpu.text.radix import RadixTree
from valkey_search_tpu.text.posting import Postings
from valkey_search_tpu.text.text_index import TextEngine, TextFieldIndex, TextOptions

__all__ = [
    "Lexer",
    "DEFAULT_PUNCTUATION",
    "DEFAULT_STOP_WORDS",
    "stem",
    "RadixTree",
    "Postings",
    "TextEngine",
    "TextFieldIndex",
    "TextOptions",
]
