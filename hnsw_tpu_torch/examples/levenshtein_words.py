"""Word search under Levenshtein distance — analog of the reference's
``examples/levensthein.rs``: a dictionary of random 5-letter words stored as u16
code points, searched with and without a sorted-id filter.

Levenshtein has a batched form (``ops/distances.scores_levenshtein``: the
row dynamic program with its insert chain as a cumulative minimum), so the
words can be inserted and searched on the device like any other metric. The
dictionary here is inserted one word at a time through the serial host path,
as the reference's single-threaded example does, and then searched both ways:
the serial ``search_filter`` / ``search`` and a batched device search.

    python -m hnsw_tpu_torch.examples.levenshtein_words [--device cuda|cpu]
"""

import argparse

import numpy as np

from hnsw_tpu_torch import Hnsw


def encode(w: str, width: int = 0) -> np.ndarray:
    v = np.zeros(max(width, len(w)), np.uint16)  # zero-padded u16 code points
    v[:len(w)] = [ord(c) for c in w]
    return v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-words", type=int, default=1000)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(7)
    n_words, wlen, charset = args.n_words, 5, "abcdefghij"
    words = ["".join(charset[c] for c in rng.integers(0, len(charset), wlen))
             for _ in range(n_words - 1)]
    words.append("abcdj")  # the reference plants a known near-match

    h = Hnsw(max_nb_connection=15, max_elements=500_000, ef_construction=200,
             dist="Levenshtein", dtype=np.uint16, device=args.device)
    for i, w in enumerate(words):
        h.insert(encode(w), i)

    query = encode("abcde")
    id_filter = sorted(range(1, 100))  # reference: ids 1..99 pass

    print("========== search with filter")
    for r in h.search_filter(query, 10, 30, id_filter):
        print(f"Word: {words[r.d_id]!r} Id: {r.d_id} Distance: {r.distance:.1f}")
        assert r.d_id in id_filter
    print("========== search without filter")
    res = h.search(query, 10, 30)
    for r in res:
        print(f"Word: {words[r.d_id]!r} Id: {r.d_id} Distance: {r.distance:.1f}")
    assert any(words[r.d_id] == "abcdj" and r.distance <= 1.0 for r in res), \
        "planted near-match should be found"
    print("========== batched search on the device")
    Q = np.stack([query, encode("abcdj"), encode(words[0]), encode(words[1])])
    rows = h.parallel_search(Q, 3, 30, mode="device")
    for w, row in zip(("abcde", "abcdj", words[0], words[1]), rows):
        print(f"{w!r}: " + ", ".join(f"{words[r.d_id]!r} ({r.distance:.0f})" for r in row))
    assert rows[0][0].distance <= 1.0 and rows[1][0].distance == 0.0
    print("OK")


if __name__ == "__main__":
    main()
