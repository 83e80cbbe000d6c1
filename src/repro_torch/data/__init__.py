"""Synthetic sLDA corpora."""
from .synthetic import make_slda_corpus, shuffle_corpus, train_test_split

__all__ = ["make_slda_corpus", "shuffle_corpus", "train_test_split"]
