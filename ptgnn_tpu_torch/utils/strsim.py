"""String similarity: Jaro and Jaro-Winkler, as the JAX package's
``utils/strsim.py`` computes them for the Graph2Seq test CLI (jellyfish's
definitions: the half-max-distance match window, Winkler's prefix boost of
0.1 over at most 4 chars, applied only above a Jaro similarity of 0.7)."""
from __future__ import annotations


def jaro_similarity(s1: str, s2: str) -> float:
    if s1 == s2:
        return 1.0
    len1, len2 = len(s1), len(s2)
    if len1 == 0 or len2 == 0:
        return 0.0
    match_window = max(len1, len2) // 2 - 1

    s1_matches = [False] * len1
    s2_matches = [False] * len2
    matches = 0
    for i, c in enumerate(s1):
        start = max(0, i - match_window)
        end = min(i + match_window + 1, len2)
        for k in range(start, end):
            if not s2_matches[k] and s2[k] == c:
                s1_matches[i] = True
                s2_matches[k] = True
                matches += 1
                break
    if matches == 0:
        return 0.0

    transpositions = 0
    k = 0
    for i in range(len1):
        if s1_matches[i]:
            while not s2_matches[k]:
                k += 1
            if s1[i] != s2[k]:
                transpositions += 1
            k += 1
    transpositions //= 2

    return (matches / len1 + matches / len2 + (matches - transpositions) / matches) / 3.0


def jaro_winkler(s1: str, s2: str, prefix_weight: float = 0.1) -> float:
    jaro = jaro_similarity(s1, s2)
    if jaro <= 0.7:  # the boost only lifts pairs that are already similar
        return jaro
    prefix = 0
    for c1, c2 in zip(s1[:4], s2[:4]):
        if c1 != c2:
            break
        prefix += 1
    return jaro + prefix * prefix_weight * (1.0 - jaro)
