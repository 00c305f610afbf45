"""An undirected graph with a power-law degree sequence, wired at random
(the configuration model), as a symmetric pattern with no self-loops.

Node ``i`` of ``rows`` asks for ``max(1, round(degree_head * (1 + i /
degree_shift) ** -degree_exponent))`` edge ends.  The ends are shuffled
(from ``pattern_seed``) and paired in order; a pair that is a self-loop or
an edge already made goes back, and the returned ends are shuffled and
paired again, for at most ``pairing_rounds`` rounds.  Ends left after the
last round are dropped, so a few nodes end with a degree or two less than
they asked for.  The configuration fits the three parameters to a
published graph's size, largest degree and wedge count.
"""
import numpy as np


def pattern(cfg):
    n = int(cfg["rows"])
    if int(cfg["cols"]) != n:
        raise ValueError("a graph's pattern is square")
    want = np.maximum(1, np.round(
        float(cfg["degree_head"])
        * (1 + np.arange(n) / float(cfg["degree_shift"]))
        ** -float(cfg["degree_exponent"]))).astype(np.int64)
    rng = np.random.default_rng(int(cfg["pattern_seed"]))
    ends = np.repeat(np.arange(n, dtype=np.int64), want)
    ends = ends[:len(ends) // 2 * 2]
    edges = np.zeros(0, np.int64)
    for _ in range(int(cfg["pairing_rounds"])):
        rng.shuffle(ends)
        u, v = ends[0::2], ends[1::2]
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        loop = lo == hi
        every = np.concatenate([edges, lo[~loop] * n + hi[~loop]])
        _, first = np.unique(every, return_index=True)
        kept = np.zeros(len(every), bool)
        kept[first] = True
        again = every[~kept]
        edges = every[kept]
        ends = np.concatenate([u[loop], v[loop], again // n, again % n])
        if not len(ends):
            break
    lo, hi = edges // n, edges % n
    key = np.unique(np.concatenate([lo * n + hi, hi * n + lo]))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(key // n, minlength=n), out=indptr[1:])
    return indptr.astype(np.int32), (key % n).astype(np.int32)
