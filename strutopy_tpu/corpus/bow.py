"""Corpus representation: ragged bag-of-words -> padded device arrays.

The reference represents a document as a python list of ``(word_idx,
count)`` tuples (gensim convention, see reference src/modules/stm.py:331
and create_dtm at src/modules/stm.py:87-119).  Ragged python lists
cannot be batched on an accelerator, so the framework's native representation is
a pair of dense, padded arrays:

  * ``words``  int32 ``(N, L)`` — unique term ids per document, padded
    with 0.
  * ``counts`` float32 ``(N, L)`` — term counts, 0.0 at padding slots
    (the count array doubles as the validity mask).

``L`` is the maximum number of *unique* terms in any document, rounded
up to a multiple of 128, so documents fall into few padded shapes and
every gather/contraction has a power-of-two-friendly width.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

LANE = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PaddedCorpus:
    """Dense, padded corpus: the framework's native document format.

    Attributes:
      words:   int32 (N, L) unique term ids, 0-padded.
      counts:  float32 (N, L) term counts, 0.0-padded.
      doc_ok:  bool (N,) False for all-padding (dummy) documents.
      V:       vocabulary size.
    """

    words: np.ndarray
    counts: np.ndarray
    doc_ok: np.ndarray
    V: int

    @property
    def N(self) -> int:
        return int(self.words.shape[0])

    @property
    def L(self) -> int:
        return int(self.words.shape[1])

    @property
    def n_docs(self) -> int:
        """Number of real (non-padding) documents."""
        return int(self.doc_ok.sum())

    @property
    def doc_lengths(self) -> np.ndarray:
        """Total token count per document (float32 (N,))."""
        return self.counts.sum(axis=1)

    def word_counts(self) -> np.ndarray:
        """Corpus-wide count of each term, float64 (V,).

        Mirror of reference ``STM.wcounts`` (src/modules/stm.py:485-486).
        """
        out = np.zeros(self.V, dtype=np.float64)
        np.add.at(out, self.words.reshape(-1), self.counts.reshape(-1))
        return out

    def pad_docs_to(self, n: int) -> "PaddedCorpus":
        """Pad the document axis up to ``n`` with dummy (masked) docs."""
        if n < self.N:
            raise ValueError(f"cannot shrink corpus from {self.N} to {n}")
        if n == self.N:
            return self
        extra = n - self.N
        words = np.concatenate(
            [self.words, np.zeros((extra, self.L), np.int32)], axis=0
        )
        counts = np.concatenate(
            [self.counts, np.zeros((extra, self.L), np.float32)], axis=0
        )
        doc_ok = np.concatenate([self.doc_ok, np.zeros(extra, bool)], axis=0)
        return PaddedCorpus(words=words, counts=counts, doc_ok=doc_ok, V=self.V)

    def pad_terms_to(self, L: int) -> "PaddedCorpus":
        """Pad the unique-term axis up to ``L``."""
        if L < self.L:
            raise ValueError(f"cannot shrink term axis from {self.L} to {L}")
        if L == self.L:
            return self
        extra = L - self.L
        words = np.pad(self.words, ((0, 0), (0, extra)))
        counts = np.pad(self.counts, ((0, 0), (0, extra)))
        return PaddedCorpus(words=words, counts=counts, doc_ok=self.doc_ok, V=self.V)

    def take(self, idx) -> "PaddedCorpus":
        idx = np.asarray(idx)
        return PaddedCorpus(
            words=self.words[idx],
            counts=self.counts[idx],
            doc_ok=self.doc_ok[idx],
            V=self.V,
        )


def pad_corpus(
    documents: Sequence[Sequence[tuple]],
    V: int | None = None,
    min_terms: int = LANE,
    lane: int = LANE,
) -> PaddedCorpus:
    """Convert BoW list-of-tuples documents into a :class:`PaddedCorpus`.

    Accepts the reference's document format ``[[(idx, count), ...], ...]``
    (see reference src/modules/stm.py:331-333).  Documents with repeated
    term ids are merged by summing counts.
    """
    N = len(documents)
    rows = []
    max_len = 1
    max_id = -1
    for doc in documents:
        if len(doc) == 0:
            rows.append((np.zeros(0, np.int64), np.zeros(0, np.float64)))
            continue
        arr = np.asarray([(int(w), float(c)) for (w, c) in doc], dtype=np.float64)
        ids = arr[:, 0].astype(np.int64)
        cts = arr[:, 1]
        if len(np.unique(ids)) != len(ids):
            uids, inv = np.unique(ids, return_inverse=True)
            ucts = np.zeros(len(uids))
            np.add.at(ucts, inv, cts)
            ids, cts = uids, ucts
        rows.append((ids, cts))
        max_len = max(max_len, len(ids))
        max_id = max(max_id, int(ids.max()))

    if V is None:
        V = max_id + 1
    elif max_id >= V:
        # out-of-vocabulary ids must error here: on device the beta
        # gather CLAMPS word ids to V-1, which would silently corrupt
        # beta_ss and the bound (e.g. a stale dictionary shorter than
        # the corpus's id range)
        raise ValueError(
            f"corpus contains word id {max_id} but V={V}; the "
            "dictionary does not cover the corpus"
        )
    L = _round_up(max(max_len, min_terms), lane)

    words = np.zeros((N, L), np.int32)
    counts = np.zeros((N, L), np.float32)
    doc_ok = np.zeros(N, bool)
    for i, (ids, cts) in enumerate(rows):
        k = len(ids)
        words[i, :k] = ids
        counts[i, :k] = cts
        doc_ok[i] = k > 0
    return PaddedCorpus(words=words, counts=counts, doc_ok=doc_ok, V=V)


def to_bow(corpus: PaddedCorpus) -> list:
    """Convert back to the reference's list-of-tuples BoW format."""
    out = []
    for i in range(corpus.N):
        mask = corpus.counts[i] > 0
        out.append(
            list(
                zip(
                    corpus.words[i, mask].tolist(),
                    [int(c) if float(c).is_integer() else float(c)
                     for c in corpus.counts[i, mask]],
                )
            )
        )
    return out


def create_dtm(documents, V: int | None = None) -> np.ndarray:
    """Dense document-term matrix (D, V) from BoW or PaddedCorpus.

    The reference builds a scipy CSR matrix (src/modules/stm.py:87-119);
    on the device the DTM only exists as an intermediate of spectral init and
    evaluation, where a dense device array (sharded by documents for
    large corpora) feeds the Gram matmul directly, so dense float64 on
    host is the canonical small-corpus form.
    """
    if isinstance(documents, PaddedCorpus):
        corpus = documents
    else:
        corpus = pad_corpus(documents, V=V)
    V = corpus.V if V is None else max(V, corpus.V)
    dtm = np.zeros((corpus.N, V), dtype=np.float64)
    rows = np.repeat(np.arange(corpus.N), corpus.L)
    np.add.at(
        dtm, (rows, corpus.words.reshape(-1)), corpus.counts.reshape(-1).astype(np.float64)
    )
    return dtm


def from_dtm(dtm) -> list:
    """BoW documents from a document-term count matrix (R-stm
    ``readCorpus(type="dtm")`` analogue; the inverse of
    :func:`create_dtm`).

    Accepts a dense (D, V) array or a scipy sparse matrix; rows become
    ``[(word_idx, count), ...]`` documents.  Entries are rounded to the
    nearest integer first and kept only when the rounded count is
    positive (a fractional entry in (0, 0.5) drops out instead of
    becoming a zero-count token); negative entries raise, since a DTM
    is a count matrix.  An all-zero row becomes an empty document —
    callers decide whether to filter, as R-stm's prepDocuments does.
    """
    if hasattr(dtm, "tocsr"):  # scipy sparse, no hard dependency
        csr = dtm.tocsr()
        if csr is dtm:  # tocsr() is a no-op on CSR input; don't mutate it
            csr = csr.copy()
        csr.sum_duplicates()  # canonicalize: one (word, count) per word per doc
        if csr.nnz and csr.data.min() < 0:
            raise ValueError("dtm has negative entries; counts must be >= 0")
        docs = []
        for d in range(csr.shape[0]):
            lo, hi = csr.indptr[d], csr.indptr[d + 1]
            docs.append(
                [(int(w), c)
                 for w, c in zip(csr.indices[lo:hi],
                                 (int(round(v)) for v in csr.data[lo:hi]))
                 if c > 0]
            )
        return docs
    dtm = np.asarray(dtm)
    if dtm.ndim != 2:
        raise ValueError(f"dtm must be 2-D (D, V), got shape {dtm.shape}")
    if dtm.size and dtm.min() < 0:
        raise ValueError("dtm has negative entries; counts must be >= 0")
    docs = []
    for row in dtm:
        counts = np.rint(row).astype(np.int64)
        (nz,) = np.nonzero(counts > 0)
        docs.append([(int(w), int(counts[w])) for w in nz])
    return docs


class Vocabulary:
    """Minimal vocabulary: id -> token mapping.

    Replaces the reference's gensim ``Dictionary`` dependency
    (reference src/modules/generate_docs.py:348-351).  Only the surface
    the reference actually uses is provided: ``len``, ``__getitem__``,
    and construction from a corpus.
    """

    def __init__(self, tokens: Iterable[str]):
        self.tokens = list(tokens)

    @classmethod
    def from_corpus(cls, documents, V: int | None = None) -> "Vocabulary":
        if isinstance(documents, PaddedCorpus):
            n = documents.V
        else:
            n = 0
            for doc in documents:
                for w, _ in doc:
                    n = max(n, int(w) + 1)
        if V is not None:
            n = max(n, V)
        return cls([str(i) for i in range(n)])

    @classmethod
    def from_tokens(cls, tokens: Sequence[str]) -> "Vocabulary":
        return cls(tokens)

    def __len__(self) -> int:
        return len(self.tokens)

    def __getitem__(self, i: int) -> str:
        return self.tokens[i]

    def __iter__(self):
        return iter(self.tokens)
