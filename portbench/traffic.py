"""The one traffic generator: every cell's traffic is a set of parameters
in its workload file, read here.

Every seed gets the same set of sizes: prompt and output lengths are the
quantiles of their clipped lognormal laws on a fixed grid, dealt into
rounds of equal work and dealt over the clients in a fixed order.  The
seed only draws the token ids (and the weights), so runs with different
seeds do the same work.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

from portbench import common


def lognormal_grid(n: int, law: dict) -> list[int]:
    """``n`` lengths at the quantiles ``(i + 0.5) / n`` of a lognormal law
    ``{"median", "sigma", "min", "max"}``, clipped to ``[min, max]``."""
    z = statistics.NormalDist()
    return [int(min(law["max"], max(law["min"], round(
        law["median"] * math.exp(law["sigma"] * z.inv_cdf((i + 0.5) / n))))))
        for i in range(n)]


def rounds(traffic: dict) -> list[list[tuple[int, int]]]:
    """The cell's ``(prompt_len, max_new_tokens)`` pairs, the same for
    every seed, in rounds of one request a client.  Each round takes one
    length from each of ``clients`` equal strata of each law, so every
    round carries about the same work and a window that ends mid-way
    through the rounds sees the same mix whatever the seed."""
    C, R = traffic["clients"], traffic["requests_per_client"]
    n = C * R
    prompts = lognormal_grid(n, traffic["prompt"])
    outputs = lognormal_grid(n, traffic["output"])
    pair = np.random.default_rng(0)
    out = []
    for r in range(R):
        strata = pair.permutation(C)
        out.append([(prompts[int(strata[k]) * R + r], outputs[k * R + r])
                    for k in range(C)])
    return out


def serve_plan(traffic: dict, seed: int, vocab: int) -> list[list[dict]]:
    """Each closed-loop client's requests in order: ``{"prompt": [ids],
    "max_new": n}``.  Each round's requests are dealt to the clients in
    one fixed order, so every seed offers the same work in the same
    order; the seed draws the prompts' ids, which are random, so no two
    prompts share a prefix."""
    deal = np.random.default_rng(1)
    ids = np.random.default_rng(common.sub_seed(seed, "prompts"))
    plan: list[list[dict]] = [[] for _ in range(traffic["clients"])]
    for rnd in rounds(traffic):
        for c, k in enumerate(deal.permutation(len(rnd))):
            p, n = rnd[int(k)]
            plan[c].append({"prompt": ids.integers(0, vocab, p).tolist(),
                            "max_new": n})
    return plan


def warmup_lengths(traffic: dict) -> list[int]:
    """Prompt lengths that reach every chunk shape the cell's prompts can
    produce: each power of two up to the longest prompt, and the longest
    prompt itself."""
    top = max(p for rnd in rounds(traffic) for p, _ in rnd)
    out, b = [], 1
    while b <= top:
        out.append(b)
        b *= 2
    return sorted(set(out + [top]))


def token_corpus(seed: int, n_tokens: int, vocab: int) -> np.ndarray:
    """A packed stream of random token ids for a training cell."""
    rng = np.random.default_rng(common.sub_seed(seed, "corpus"))
    return rng.integers(0, vocab, n_tokens, dtype=np.int64).astype(
        np.uint16 if vocab <= 1 << 16 else np.int32)
