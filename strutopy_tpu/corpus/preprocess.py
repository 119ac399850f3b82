"""Text preprocessing: raw documents -> BoW corpus + vocabulary.

Covers the reference's corpus-construction pipeline
(`src/02_create_corpus.py:11-44`): punctuation/digit stripping,
stopword removal, and doc2bow conversion — without the gensim
dependency.  (The upstream step, `src/01_get_wiki_docs.py`, scrapes
Wikipedia and needs network access; its output contract — a table of
(id, text, labels) — is the input contract of this module.)
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Iterable, Optional, Sequence

import numpy as np

from strutopy_tpu.corpus.bow import Vocabulary

# A compact English stopword list (reference uses a bundled
# stop_words_english.txt, src/02_create_corpus.py:29-35).
DEFAULT_STOPWORDS = frozenset(
    """a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for from
further had hadn't has hasn't have haven't having he he'd he'll he's her here
here's hers herself him himself his how how's i i'd i'll i'm i've if in into
is isn't it it's its itself let's me more most mustn't my myself no nor not of
off on once only or other ought our ours ourselves out over own same shan't
she she'd she'll she's should shouldn't so some such than that that's the
their theirs them themselves then there there's these they they'd they'll
they're they've this those through to too under until up very was wasn't we
we'd we'll we're we've were weren't what what's when when's where where's
which while who who's whom why why's with won't would wouldn't you you'd
you'll you're you've your yours yourself yourselves also may many must used
use using one two first second new however since within upon often e g""".split()
)

_PUNCT_DIGIT_RE = re.compile(f"[{re.escape(string.punctuation)}0-9]")


def tokenize(
    text: str,
    stopwords: Optional[frozenset] = DEFAULT_STOPWORDS,
    min_len: int = 2,
) -> list:
    """Lowercase, strip punctuation/digits, split, drop stopwords.

    Mirrors reference src/02_create_corpus.py:23-35.
    """
    text = text.lower()
    text = _PUNCT_DIGIT_RE.sub(" ", text)
    toks = [t for t in text.split() if len(t) >= min_len]
    if stopwords:
        toks = [t for t in toks if t not in stopwords]
    return toks


def build_corpus(
    texts: Iterable[str],
    stopwords: Optional[frozenset] = DEFAULT_STOPWORDS,
    min_doc_freq: int = 1,
    max_doc_frac: float = 1.0,
    stem: bool = False,
    ngrams: bool = False,
    ngram_min_count: int = 5,
    ngram_threshold: float = 10.0,
    use_native: bool = True,
):
    """Tokenize texts -> (bow_corpus, Vocabulary).

    BoW output uses the reference's list-of-(idx, count) convention.
    ``min_doc_freq`` / ``max_doc_frac`` filter rare/ubiquitous terms;
    ``stem`` applies the Porter stemmer and ``ngrams`` merges learned
    bigram collocations (both README-promised preprocessing stages the
    reference never implemented).

    The default path (no stemming/n-grams) runs in C++
    (native/bow.cpp; exact-parity contract in tests/test_native_bow.py)
    and falls back to this module's python implementation when the
    toolchain is unavailable or ``use_native=False``.
    """
    texts = list(texts)
    if use_native and not stem and not ngrams:
        from strutopy_tpu.corpus import native

        res = native.build_bow(
            texts, stopwords, min_len=2,
            min_doc_freq=min_doc_freq, max_doc_frac=max_doc_frac,
        )
        if res is not None:
            bow, vocab_tokens = res
            return bow, Vocabulary.from_tokens(vocab_tokens)

    token_docs = [tokenize(t, stopwords) for t in texts]
    if ngrams:
        from strutopy_tpu.corpus.ngrams import ngram_docs

        token_docs, _ = ngram_docs(
            token_docs, min_count=ngram_min_count, threshold=ngram_threshold
        )
    if stem:
        from strutopy_tpu.corpus.stem import stem_tokens

        token_docs = [stem_tokens(t) for t in token_docs]
    doc_freq: Counter = Counter()
    for toks in token_docs:
        doc_freq.update(set(toks))
    n_docs = len(token_docs)
    keep = {
        t
        for t, df in doc_freq.items()
        if df >= min_doc_freq and df <= max_doc_frac * n_docs
    }
    vocab_tokens = sorted(keep)
    index = {t: i for i, t in enumerate(vocab_tokens)}

    bow = []
    for toks in token_docs:
        counts = Counter(t for t in toks if t in keep)
        bow.append(sorted((index[t], c) for t, c in counts.items()))
    return bow, Vocabulary.from_tokens(vocab_tokens)


def removed_by_threshold(
    texts: Iterable[str],
    thresholds: Sequence[int],
    stopwords: Optional[frozenset] = DEFAULT_STOPWORDS,
) -> dict:
    """Words/documents/tokens removed per lower document-frequency
    threshold (R-stm ``plotRemoved``'s statistic; absent upstream).

    For each candidate ``min_doc_freq`` value, reports how many
    vocabulary terms would be dropped, how many tokens those terms
    carry, and how many documents would become EMPTY — the standard
    view for choosing ``build_corpus(min_doc_freq=...)``.

    Tokenizes once; each threshold is then a histogram lookup.
    """
    token_docs = [tokenize(t, stopwords) for t in texts]
    doc_freq: Counter = Counter()
    tok_count: Counter = Counter()
    for toks in token_docs:
        doc_freq.update(set(toks))
        tok_count.update(toks)
    # per-doc survival: a doc dies at threshold t if every term it
    # contains has doc_freq < t
    doc_max_df = [
        max((doc_freq[t] for t in set(toks)), default=0) for toks in token_docs
    ]
    out = {"threshold": [], "words_removed": [], "tokens_removed": [],
           "docs_removed": []}
    for thr in thresholds:
        thr = int(thr)
        dropped = [t for t, df in doc_freq.items() if df < thr]
        out["threshold"].append(thr)
        out["words_removed"].append(len(dropped))
        out["tokens_removed"].append(sum(tok_count[t] for t in dropped))
        out["docs_removed"].append(sum(1 for m in doc_max_df if m < thr))
    return out


def align_corpus(
    docs,
    vocab,
    stopwords: Optional[frozenset] = DEFAULT_STOPWORDS,
    use_native: bool = True,
) -> tuple:
    """Encode NEW documents against a fitted model's vocabulary
    (R-stm ``alignCorpus``; absent upstream — the reference can only
    score documents that were encoded together with the training set).

    ``docs``: raw text strings or pre-tokenized lists of tokens.
    ``vocab``: the model's Vocabulary (or any iterable of tokens in id
    order).  Out-of-vocabulary tokens are dropped — a fitted beta has
    no column for them.

    Returns (bow, report): ``bow`` in the framework's list-of-
    (id, count) convention, ready for ``STM.transform`` /
    ``ThetaServer``; ``report`` says what was lost:
    ``tokens_dropped`` (total OOV token occurrences), ``oov_types``
    (distinct OOV terms), ``docs_emptied`` (documents with no
    in-vocabulary token left).
    """
    index = {t: i for i, t in enumerate(vocab)}
    docs = list(docs)
    if use_native and docs and all(isinstance(d, str) for d in docs):
        # hot path for raw-text serving: tokenize + count in C++
        # against a per-request vocabulary, then remap per TYPE (the
        # python per-token loop caps at ~3k docs/s on the host, so
        # encoding would bottleneck bulk serving)
        from strutopy_tpu.corpus import native

        res = native.build_bow(docs, stopwords)
        if res is not None:
            raw_bow, req_tokens = res
            remap = np.array(
                [index.get(t, -1) for t in req_tokens], dtype=np.int64
            )
            bow = []
            tokens_dropped = 0
            docs_emptied = 0
            for doc in raw_bow:
                enc = sorted(
                    (int(remap[w]), int(c)) for w, c in doc if remap[w] >= 0
                )
                tokens_dropped += sum(int(c) for w, c in doc if remap[w] < 0)
                if doc and not enc:
                    docs_emptied += 1
                bow.append(enc)
            report = {
                "tokens_dropped": tokens_dropped,
                "oov_types": int(np.sum(remap < 0)),
                "docs_emptied": docs_emptied,
            }
            return bow, report

    bow = []
    tokens_dropped = 0
    oov: set = set()
    docs_emptied = 0
    for doc in docs:
        toks = tokenize(doc, stopwords) if isinstance(doc, str) else list(doc)
        counts: Counter = Counter()
        for t in toks:
            i = index.get(t)
            if i is None:
                tokens_dropped += 1
                oov.add(t)
            else:
                counts[i] += 1
        if toks and not counts:
            docs_emptied += 1
        bow.append(sorted(counts.items()))
    report = {
        "tokens_dropped": tokens_dropped,
        "oov_types": len(oov),
        "docs_emptied": docs_emptied,
    }
    return bow, report
