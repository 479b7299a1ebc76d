"""MoE expert co-activation traces and the moe-8 / moe-2 hypergraphs.

The paper (§B.1) builds hypergraphs from profiled expert usage of MoE LLMs:
for every token, the 8-tuple of experts invoked on a layer is recorded; the
most frequent 8-tuples become hyperedges (weight = frequency normalized to
[1,10]) until the pin count reaches kappa_0 ~ 1000; isolated experts are
dropped.  moe-2 does the same with all C(8,2) expert pairs.

The published traces (Qwen3-235B / DeepSeek-R1 on MMLU) are not available
offline, so ``synthetic_trace`` generates token->8-tuple traces with the
salient statistics of real MoE routing: a Zipf-like expert popularity skew
plus topic clustering (tokens from a topic prefer a correlated expert
subset), which is what makes co-activation partitioning non-trivial.

``trace_to_moe8`` / ``trace_to_moe2`` then follow the paper's construction
verbatim.  The same code path is used by the *runtime* profiler
(`repro.core.placement`): there the trace comes from the actual router of a
running model instead of the synthetic generator.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

from ..core.hypergraph import Hypergraph


def _topic_model(rng: np.random.Generator, n_experts: int, n_topics: int,
                 top_k: int, zipf_a: float, topic_strength: float):
    """Shared router model: Zipf popularity + per-topic favorite sets +
    universal hub experts.  Consumes the rng in a fixed order so
    ``synthetic_trace`` stays byte-identical to its pre-refactor output.
    Returns ``(log_pop (E,), topic_boost (n_topics, E))``."""
    pop = 1.0 / np.arange(1, n_experts + 1) ** zipf_a
    pop = pop[rng.permutation(n_experts)]
    pop /= pop.sum()
    topic_boost = np.full((n_topics, n_experts), 1e-3)
    # universal hub experts: co-activated by every topic (the analogue of
    # always-hot experts in real routers; these are what replication wins on)
    hubs = rng.choice(n_experts, size=max(2, top_k // 4), replace=False)
    for t in range(n_topics):
        fav = rng.choice(n_experts, size=top_k + 3, replace=False)
        topic_boost[t, fav] += topic_strength
        topic_boost[t, hubs] += topic_strength * 1.5
    return np.log(pop), topic_boost


def _sample_tuples(rng: np.random.Generator, log_pop: np.ndarray,
                   topic_boost: np.ndarray, topic_of_token: np.ndarray,
                   top_k: int, gumbel_scale: float) -> np.ndarray:
    """Gumbel-top-k routing of each token through its topic's logits."""
    n_experts = log_pop.shape[0]
    logits = log_pop[None, :] + np.log(topic_boost[topic_of_token])
    gumbel = rng.gumbel(size=(len(topic_of_token), n_experts)) * gumbel_scale
    out = np.argpartition(-(logits + gumbel), top_k, axis=1)[:, :top_k]
    return np.sort(out.astype(np.int32), axis=1)


def synthetic_trace(
    n_experts: int = 128,
    n_tokens: int = 50_000,
    top_k: int = 8,
    n_topics: int = 16,
    zipf_a: float = 1.1,
    topic_strength: float = 12.0,
    gumbel_scale: float = 1.5,
    seed: int = 0,
) -> np.ndarray:
    """Token -> top-k expert tuples, shape (n_tokens, top_k).

    Co-activation in real MoE traces is highly concentrated: tokens of one
    topic invoke near-identical expert tuples (that is what makes the
    paper's moe-8 hyperedges heavy).  Each topic has a small favorite set
    barely larger than top_k, so its tokens mostly produce the same tuple
    with occasional swaps; a mild global Zipf makes some experts hubs
    across topics.
    """
    rng = np.random.default_rng(seed)
    log_pop, topic_boost = _topic_model(rng, n_experts, n_topics, top_k,
                                        zipf_a, topic_strength)
    topic_of_token = rng.integers(0, n_topics, size=n_tokens)
    return _sample_tuples(rng, log_pop, topic_boost, topic_of_token, top_k,
                          gumbel_scale)


def drifting_trace(
    n_experts: int = 128,
    tokens_per_epoch: int = 10_000,
    n_epochs: int = 20,
    top_k: int = 8,
    n_topics: int = 16,
    drift_rate: float = 0.0,
    zipf_a: float = 1.1,
    topic_strength: float = 12.0,
    gumbel_scale: float = 1.5,
    seed: int = 0,
):
    """Epoch-chunked router traffic with a *drifting topic mixture*.

    The expert/topic model is the same as ``synthetic_trace``'s, but the
    topic mixture each epoch samples from is a circular Gaussian bump whose
    center rotates by ``drift_rate`` topics per epoch -- the online
    data-placement regime: co-activation structure is stable *within* an
    epoch and drifts *across* epochs, so a placement planned on early
    traffic slowly goes stale.  ``drift_rate=0`` is the stationary control:
    every epoch draws i.i.d. chunks from the same mixture (the
    zero-migration acceptance case of the online controller).

    Yields ``n_epochs`` arrays of shape (tokens_per_epoch, top_k), each
    sampled with an epoch-keyed rng so chunks are reproducible and
    stationarity is exact (no rng state carried across epochs).
    """
    model_rng = np.random.default_rng(seed)
    log_pop, topic_boost = _topic_model(model_rng, n_experts, n_topics,
                                        top_k, zipf_a, topic_strength)
    sigma = max(1.0, n_topics / 6.0)
    topics = np.arange(n_topics)
    for epoch in range(n_epochs):
        center = (drift_rate * epoch) % n_topics
        dist = np.minimum(np.abs(topics - center),
                          n_topics - np.abs(topics - center))
        w = np.exp(-0.5 * (dist / sigma) ** 2)
        w /= w.sum()
        rng = np.random.default_rng([seed, 1 + epoch])
        topic_of_token = rng.choice(n_topics, size=tokens_per_epoch, p=w)
        yield _sample_tuples(rng, log_pop, topic_boost, topic_of_token,
                             top_k, gumbel_scale)


def select_frequent_tuples(counter: Counter, kappa0: int, tuple_size: int
                           ) -> tuple[list[tuple], np.ndarray]:
    """Most frequent tuples until >= kappa0 pins, with mu normalized to
    [1, 10] (paper §B.1).  The single home of the selection + weighting
    rule: ``trace_to_moe8``/``trace_to_moe2``, the full-expert-space
    runtime path (``core.placement.expert_placement``) and the online
    accumulator (``core.placement.online``) all price edges through it."""
    items = counter.most_common()
    edges, freqs, pins = [], [], 0
    for tup, f in items:
        edges.append(tuple(tup))
        freqs.append(f)
        pins += tuple_size
        if pins >= kappa0:
            break
    freqs = np.asarray(freqs, dtype=np.float64)
    return edges, normalize_mu(freqs)


def normalize_mu(freqs: np.ndarray) -> np.ndarray:
    """Frequency -> edge weight: affine map onto [1, 10] (paper §B.1)."""
    if len(freqs) and freqs.max() > freqs.min():
        mu = 1.0 + 9.0 * (freqs - freqs.min()) / (freqs.max() - freqs.min())
    else:
        mu = np.ones_like(freqs)
    return np.maximum(mu, 1.0)


def _tuples_to_hypergraph(counter: Counter, kappa0: int, tuple_size: int,
                          name: str, n: int | None = None,
                          drop_isolated: bool = True) -> Hypergraph:
    """Hypergraph over the selected tuples.  With ``n``/``drop_isolated=
    False`` the node space is the FULL expert id range (experts outside the
    frequent tuples become edge-free nodes the balance constraint still has
    to place -- the runtime placement construction)."""
    edges, mu = select_frequent_tuples(counter, kappa0, tuple_size)
    if n is None:
        n = int(max(v for e in edges for v in e)) + 1
    hg = Hypergraph(n=n, edges=edges, mu=mu, name=name)
    return hg.remove_isolated() if drop_isolated else hg


def trace_counter(trace: np.ndarray) -> Counter:
    """Exact tuple counts of a (T, k) trace (rows assumed sorted)."""
    uniq, counts = np.unique(trace, axis=0, return_counts=True)
    return Counter({tuple(int(x) for x in row): int(c)
                    for row, c in zip(uniq, counts)})


def trace_to_moe8(trace: np.ndarray, kappa0: int = 1000,
                  name: str = "moe8", n: int | None = None,
                  drop_isolated: bool = True) -> Hypergraph:
    return _tuples_to_hypergraph(trace_counter(trace), kappa0,
                                 trace.shape[1], name, n=n,
                                 drop_isolated=drop_isolated)


def trace_to_moe2(trace: np.ndarray, kappa0: int = 1000,
                  name: str = "moe2", n: int | None = None,
                  drop_isolated: bool = True) -> Hypergraph:
    k = trace.shape[1]
    n_exp = int(trace.max()) + 1
    ii, jj = np.triu_indices(k, k=1)
    codes = (trace[:, ii].astype(np.int64) * n_exp
             + trace[:, jj].astype(np.int64)).ravel()
    uniq, counts = np.unique(codes, return_counts=True)
    counter = Counter({(int(c // n_exp), int(c % n_exp)): int(f)
                       for c, f in zip(uniq, counts)})
    return _tuples_to_hypergraph(counter, kappa0, 2, name, n=n,
                                 drop_isolated=drop_isolated)


def moe_dataset(kind: str = "moe8", n_layers: int = 5, kappa0: int = 1000,
                n_experts: int = 128, seed: int = 0) -> list[Hypergraph]:
    """One hypergraph per 'layer' (independent trace), like Qwen_l0..l4."""
    out = []
    for layer in range(n_layers):
        trace = synthetic_trace(n_experts=n_experts, seed=seed * 100 + layer)
        fn = trace_to_moe8 if kind == "moe8" else trace_to_moe2
        hg = fn(trace, kappa0=kappa0, name=f"{kind}_l{layer}")
        out.append(hg)
    return out
