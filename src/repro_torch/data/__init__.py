"""Synthetic sLDA corpora and the synthetic LM token stream."""
from .lm import lm_batch_iterator, synthetic_lm_batch
from .synthetic import make_slda_corpus, shuffle_corpus, train_test_split

__all__ = ["make_slda_corpus", "shuffle_corpus", "train_test_split",
           "lm_batch_iterator", "synthetic_lm_batch"]
